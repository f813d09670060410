"""Host input and output helpers (femto_tpu/io): the native C++ library's
binding."""
