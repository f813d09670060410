"""The LCP analytics' device steps: kernel wrappers + plain versions.

The counterparts of femto_tpu/lcp.py _lcp_round_jit and
_compact_lanes_jit (K17).  Each wrapper launches its kernel in
csrc/lcp.cu for tensors on the card and takes the plain PyTorch version
beside it for tensors on the CPU; a CUDA tensor never falls back.
"""

from __future__ import annotations

import torch

from .. import kernels

LCP_W_MIN = 32     # the first round's window
LCP_W_MAX = 4096   # the window stops doubling here
# lanes x window the plain round compares at once
_PLAIN_CHUNK = 1 << 22


def lcp_round_plain(text: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                    h: torch.Tensor, valid: torch.Tensor, W: int):
    """femto_tpu's round: the W-symbol windows of both sides compared at
    once, ml = the length of the equal prefix (the text's end padded with
    -1 and -2), in chunks of lanes."""
    n = text.shape[0]
    hs, acts = [], []
    step = max(1, _PLAIN_CHUNK // W)
    k = torch.arange(W, device=text.device)
    for a in range(0, i.shape[0], step):
        sl = slice(a, a + step)
        hh = h[sl].long()
        ii = (i[sl].long() + hh)[:, None] + k
        jj = (j[sl].long() + hh)[:, None] + k
        wi = torch.where(ii < n, text[torch.clamp(ii, max=n - 1)], -1)
        wj = torch.where(jj < n, text[torch.clamp(jj, max=n - 1)], -2)
        eq = (wi == wj) & valid[sl, None]
        ml = torch.cumprod(eq.to(torch.int32), dim=1).sum(dim=1)
        hs.append((hh + ml).to(torch.int32))
        acts.append(valid[sl] & (ml == W))
    if not hs:
        return h.clone(), valid.clone()
    return torch.cat(hs), torch.cat(acts)


def lcp_round(text: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
              h: torch.Tensor, valid: torch.Tensor, W: int):
    """One round of the windowed LCP compare: lanes (i, j, h) int32[B] and
    valid bool[B] over text int32[n] -> (h + ml int32[B], live bool[B]),
    ml the equal symbols of text[i+h:][:W] and text[j+h:][:W] before the
    first mismatch (the text's end one), live = valid & (ml == W).
    Invalid lanes keep h.  W a multiple of 32.  Kernel S on the card."""
    B = i.shape[0]
    kernels.check(text, "text", torch.int32, 1)
    for name, t in (("i", i), ("j", j), ("h", h)):
        kernels.check(t, name, torch.int32, 1, (B,))
    kernels.check(valid, "valid", torch.bool, 1, (B,))
    if W <= 0 or W % 32:
        raise ValueError("W must be a positive multiple of 32")
    if not kernels.on_card(text, i, j, h, valid):
        return lcp_round_plain(text, i, j, h, valid, W)
    h_out = torch.empty_like(h)
    act = torch.empty_like(valid)
    kernels.launch("lcp_round", text.data_ptr(), text.shape[0], i.data_ptr(),
                   j.data_ptr(), h.data_ptr(), valid.data_ptr(), B, W,
                   h_out.data_ptr(), act.data_ptr())
    return h_out, act


def lcp_compact_plain(out: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                      h: torch.Tensor, act: torch.Tensor, orig: torch.Tensor,
                      M_out: int):
    """femto_tpu's compaction (a cumsum and scatters), out updated in
    place: (i, j, h, orig int32[M_out], live count int32[1])."""
    B_out = out.shape[0]
    done = ~act & (orig >= 0) & (orig < B_out)
    out[orig[done].long()] = h[done]
    pos = torch.cumsum(act.to(torch.int64), dim=0) - 1
    keep = act & (pos < M_out)
    tgt = pos[keep]

    def comp(x, fill):
        y = torch.full((M_out,), fill, dtype=torch.int32, device=x.device)
        y[tgt] = x[keep]
        return y

    count = act.sum().to(torch.int32).reshape(1)
    return comp(i, 0), comp(j, 0), comp(h, 0), comp(orig, B_out), count


def lcp_compact(out: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                h: torch.Tensor, act: torch.Tensor, orig: torch.Tensor,
                M_out: int):
    """Retire the resolved lanes and compact the live ones: out[orig] = h
    (in place) where not act and orig < len(out); the act lanes' (i, j, h,
    orig) stably into M_out slots, the slots past them 0, 0, 0 and
    len(out); lanes past M_out drop.  Lanes int32[M_in], act bool[M_in].
    Returns (i, j, h, orig int32[M_out], the live count int32[1] on the
    lanes' device).  Kernel S on the card: a block scan per tile of lanes
    and one pass over the tiles' offsets."""
    M_in = i.shape[0]
    kernels.check(out, "out", torch.int32, 1)
    for name, t in (("i", i), ("j", j), ("h", h), ("orig", orig)):
        kernels.check(t, name, torch.int32, 1, (M_in,))
    kernels.check(act, "act", torch.bool, 1, (M_in,))
    if M_out < 0:
        raise ValueError("M_out must be >= 0")
    if not kernels.on_card(out, i, j, h, act, orig):
        return lcp_compact_plain(out, i, j, h, act, orig, M_out)
    outs = [torch.empty(M_out, dtype=torch.int32, device=i.device)
            for _ in range(4)]
    scratch = torch.empty(kernels.size("lcp_compact_scratch",
                                       max(M_in, M_out)),
                          dtype=torch.int32, device=i.device)
    kernels.launch("lcp_compact", out.data_ptr(), out.shape[0], i.data_ptr(),
                   j.data_ptr(), h.data_ptr(), act.data_ptr(),
                   orig.data_ptr(), M_in, M_out,
                   *(o.data_ptr() for o in outs), scratch.data_ptr())
    return (*outs, scratch[-1:])
