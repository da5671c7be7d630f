"""Mamba-2 (SSD, state-space duality) block in PyTorch.

Mirrors the JAX package's ``models/mamba.py``. Prefill runs the chunked SSD
algorithm [arXiv:2405.21060 §6]: quadratic, attention-like products inside
a chunk and a linear state recurrence across chunks (a Python loop over
chunks where the reference scans). Decode is the O(1) recurrent state
update. The reference has no Pallas kernel here, so every step is plain
torch (``einsum``, ``cumsum``, ``matmul``) on the CPU and on CUDA alike.

Single B/C group shared across heads and a scalar decay per head, the
standard Mamba-2 parameterization. ``A_log``, ``D`` and ``dt_bias`` are
float32 in every model; the SSM state is float32, the conv state is in the
activation dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def init_mamba(cfg: ModelConfig, lead: Tuple[int, ...], generator, device) -> Params:
    """The JAX init's shapes, dtypes and scales, with a leading ``lead``
    axis. ``dt_bias`` is the inverse softplus of a step drawn log-uniform in
    [1e-3, 1e-1]."""
    d, di, ns, nh, dc = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.d_conv
    ci = di + 2 * ns                 # conv channels: x, B, C
    proj_out = 2 * di + 2 * ns + nh  # z, x, B, C, dt
    f32 = torch.float32
    if torch.device(device).type == "meta":
        # factories only: the first op on a meta tensor loads PyTorch's meta
        # kernels, seconds on the first template a process builds
        a_log, dt_bias = (torch.empty(*lead, nh, dtype=f32, device=device) for _ in "ad")
    else:
        u = torch.rand(*lead, nh, generator=generator, dtype=f32, device=device)
        log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
        dt_bias = torch.log(torch.expm1(torch.exp(log_dt)))
        a_log = torch.log(torch.arange(1, nh + 1, dtype=f32, device=device)).expand(
            *lead, nh).clone()
    return {
        "in_proj": dense_init((*lead, d, proj_out), cfg.pdtype, generator, device),
        "conv_w": dense_init((*lead, dc, ci), cfg.pdtype, generator, device,
                             scale=1.0 / math.sqrt(dc)),
        "conv_b": torch.zeros(*lead, ci, dtype=cfg.pdtype, device=device),
        "A_log": a_log,
        "D": torch.ones(*lead, nh, dtype=f32, device=device),
        "dt_bias": dt_bias,
        "out_norm": torch.ones(*lead, di, dtype=cfg.pdtype, device=device),
        "out_proj": dense_init((*lead, di, d), cfg.pdtype, generator, device,
                               scale=1.0 / math.sqrt(di * 2 * cfg.n_layers)),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, ns = cfg.d_inner, cfg.d_state
    return proj[..., :di], proj[..., di:2 * di + 2 * ns], proj[..., 2 * di + 2 * ns:]


def _causal_conv(p: Params, xBC: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over (B, L, C), then SiLU. The products are
    summed in float32 and rounded once to the activation dtype, as XLA's
    feature-grouped convolution in the reference does."""
    dc, C = p["conv_w"].shape
    w = p["conv_w"].to(xBC.dtype).float().t()[:, None, :]              # (C, 1, W)
    out = F.conv1d(xBC.float().transpose(1, 2), w, padding=dc - 1, groups=C)
    out = out[..., :xBC.shape[1]].transpose(1, 2).to(xBC.dtype)
    return F.silu(out + p["conv_b"].to(xBC.dtype))


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm of ``y * silu(z)`` in float32, as the reference computes it
    (no kernel: the reference's is plain jnp)."""
    yf = (y * F.silu(z)).float()
    var = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * p["out_norm"].float()).to(y.dtype)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x:  (B, L, H, P) head inputs
    dt: (B, L, H)    positive step sizes (softplus applied)
    A:  (H,)         negative per-head decay rates
    Bm: (B, L, N)    input projection (single group)
    Cm: (B, L, N)    output projection
    Returns (y (B,L,H,P) in x's dtype, final_state (B,H,N,P) float32).

    Inside a chunk the products run heads-major, (B, nc, H, Q, Q), so that
    the quadratic term is one batched matmul; the sums are the reference's.
    """
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    Lp = -(-L // Q) * Q
    if Lp != L:
        # zero-pad the tail: dt = 0 means decay 1 and no input; the output
        # is truncated below
        pad = Lp - L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = Lp // Q

    f32 = torch.float32
    xc = x.reshape(Bsz, nc, Q, H, P).to(f32).permute(0, 1, 3, 2, 4)    # (B,nc,H,Q,P)
    dtc = dt.reshape(Bsz, nc, Q, H).to(f32).permute(0, 1, 3, 2)        # (B,nc,H,Q)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(f32)

    dA = dtc * A.to(f32)[None, None, :, None]                          # <= 0
    cs = torch.cumsum(dA, dim=-1)                                      # within the chunk

    # intra-chunk (quadratic) term. decay[i, j] = exp(cs_i - cs_j) for
    # j <= i. Mask the EXPONENT: for j > i the difference is positive and
    # exp() would overflow to inf, and inf * 0 is NaN.
    expo = cs[..., :, None] - cs[..., None, :]                         # (B,nc,H,Q,Q)
    ii = torch.arange(Q, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    Lmat = torch.exp(expo.masked_fill(~causal, float("-inf")))
    scores = Cc @ Bc.transpose(-1, -2)                                 # (B,nc,Q,Q)
    w = scores[:, :, None] * Lmat * dtc[..., None, :]                  # (B,nc,H,Q,Q)
    y_intra = w @ xc                                                   # (B,nc,H,Q,P)

    # per-chunk terminal states: S_c = sum_j exp(cs_last - cs_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cs[..., -1:] - cs)                        # (B,nc,H,Q)
    Sc = torch.einsum("bchj,bcjn,bchjp->bchnp", decay_to_end * dtc, Bc, xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cs[..., -1])                               # (B,nc,H)
    s = (torch.zeros(Bsz, H, N, P, dtype=f32, device=x.device) if init_state is None
         else init_state.to(f32))
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = chunk_decay[:, c, :, None, None] * s + Sc[:, c]
    s_in = torch.stack(s_in, dim=1)                                    # (B,nc,H,N,P)

    # inter-chunk output: y_inter[i] = exp(cs_i) * C_i . S_in
    y_inter = torch.einsum("bcin,bchnp->bchip", Cc, s_in) * torch.exp(cs)[..., None]

    y = (y_intra + y_inter).permute(0, 1, 3, 2, 4).reshape(Bsz, Lp, H, P)[:, :L]
    return y.to(x.dtype), s


def ssd_reference(x, dt, A, Bm, Cm, init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential-time oracle for :func:`ssd_chunked` (property tests)."""
    Bsz, L, H, P = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    s = (torch.zeros(Bsz, H, N, P, dtype=f32, device=x.device) if init_state is None
         else init_state.to(f32))
    dt, Bm, Cm = dt.to(f32), Bm.to(f32), Cm.to(f32)
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * A[None])                          # (B,H)
        s = s * decay[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhnp", dt[:, t], Bm[:, t], x[:, t].to(f32))
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype), s


def apply_mamba(cfg: ModelConfig, p: Params, x: torch.Tensor, return_state: bool = False):
    """Full Mamba-2 mixer. x: (B, L, D) -> (B, L, D) [, (ssm state, conv tail)]."""
    Bsz, L, _ = x.shape
    di, ns, nh, hp = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.ssm_headdim

    proj = x @ p["in_proj"].to(x.dtype)
    z, xBC_raw, dt_raw = _split_proj(cfg, proj)
    xBC = _causal_conv(p, xBC_raw)
    xs = xBC[..., :di].reshape(Bsz, L, nh, hp)
    Bm = xBC[..., di:di + ns]
    Cm = xBC[..., di + ns:]

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, sN = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + xs * p["D"].to(x.dtype)[None, None, :, None]
    out = _gated_norm(p, y.reshape(Bsz, L, di), z) @ p["out_proj"].to(x.dtype)
    if return_state:
        # decode needs the last (d_conv - 1) PRE-conv inputs, left-padded
        # with zeros when the prompt is shorter
        conv_tail = F.pad(xBC_raw, (0, 0, cfg.d_conv - 1, 0))[:, L:L + cfg.d_conv - 1]
        return out, (sN, conv_tail)
    return out


def mamba_decode_step(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      ssm_state: torch.Tensor, conv_state: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token recurrent step.

    x: (B, 1, D); ssm_state: (B, H, N, P); conv_state: (B, d_conv-1, ci).
    Returns (out (B,1,D), new_ssm_state, new_conv_state), new tensors: the
    caller decides where they are written.
    """
    Bsz = x.shape[0]
    di, ns, nh, hp = cfg.d_inner, cfg.d_state, cfg.n_ssm_heads, cfg.ssm_headdim

    proj = x[:, 0] @ p["in_proj"].to(x.dtype)                          # (B, proj)
    z, xBC, dt_raw = _split_proj(cfg, proj)

    # conv: window = [conv_state, xBC], products summed in float32
    win = torch.cat([conv_state.to(x.dtype), xBC[:, None, :]], dim=1)  # (B, dc, ci)
    w = p["conv_w"].to(x.dtype)
    conv = (win.float() * w.float()).sum(1).to(x.dtype)
    conv_out = F.silu(conv + p["conv_b"].to(x.dtype))
    new_conv_state = win[:, 1:]

    xs = conv_out[..., :di].reshape(Bsz, nh, hp)
    Bm = conv_out[..., di:di + ns].float()
    Cm = conv_out[..., di + ns:].float()

    dt = F.softplus(dt_raw.float() + p["dt_bias"][None])               # (B,H)
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None])                                    # (B,H)
    s = ssm_state.float() * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, Bm, xs.float())
    y = torch.einsum("bn,bhnp->bhp", Cm, s).to(x.dtype)
    y = y + xs * p["D"].to(x.dtype)[None, :, None]
    out = _gated_norm(p, y.reshape(Bsz, di), z) @ p["out_proj"].to(x.dtype)
    return out[:, None, :], s.to(ssm_state.dtype), new_conv_state
