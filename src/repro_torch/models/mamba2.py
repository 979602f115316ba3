"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

Counterpart of ``repro/models/mamba2.py``, in plain PyTorch. Training
takes the chunked SSD algorithm: within a chunk of ``ssm_chunk`` steps the
recurrence is evaluated in its dual quadratic ("attention-like") form,
and a loop over the chunks carries the (H, P, N) state with each chunk's
decay (the reference's ``lax.scan``; at most a few tens of chunks).
The reference's scan is XLA code, not a Pallas kernel, so its plain
version is its port, as with the decoder's attention.

Decoding carries a constant-size recurrent state: the f32 (B, H, P, N)
SSM state and the last W - 1 raw inputs of the width-W causal conv
(``init_mamba_cache``); ``mamba_decode`` writes both in place.

Every cast sits where the reference puts it: the conv sums its W taps in
f32 from zeros in tap order, then adds the bias, applies silu and casts;
the scan runs in f32; the D skip is added in f32; the gate ``y *
silu(z)`` is taken in y's dtype before ``rms_norm``. softplus is jax's,
``logaddexp(x, 0)`` (torch's own takes another formula below its
threshold and differs in the last bits). ``A_log``, ``D`` and ``dt_bias``
are f32 in every config, whatever ``param_dtype`` says, as the
reference's init makes them: a bf16 model's tree is of mixed dtypes.
silu is the reference's law exactly (``layers.silu``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm, silu


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_mamba(gen, cfg: ModelConfig, lead=(), dtype=None) -> dict:
    """One Mamba2 block's parameters, drawn from ``gen`` on its device
    (nothing drawn on ``meta``); ``lead`` stacks them over the
    super-blocks, each slice drawn at the single block's fan-in. The
    reference's leaves: ``A_log`` = log(1..H), ``D`` ones and ``dt_bias``
    (softplus(dt_bias) uniform in log space on [1e-3, 1e-1]) in f32, the
    rest in ``dtype`` (default the config's parameter dtype)."""
    lead, dev = tuple(lead), gen.device
    dtype = dtype or cfg.p_dtype
    d, di = cfg.d_model, cfg.d_inner
    h, n, g = cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    conv_ch = _conv_channels(cfg)
    f32 = torch.float32
    conv_w = torch.empty(lead + (cfg.ssm_conv, conv_ch), dtype=f32,
                         device=dev)
    dt_u = torch.empty(lead + (h,), dtype=f32, device=dev)
    if dev.type != "meta":
        conv_w.normal_(0.0, 1.0, generator=gen)
        dt_u.uniform_(math.log(1e-3), math.log(1e-1), generator=gen)
    a_log = torch.log(torch.arange(1, h + 1, dtype=f32, device=dev))
    return {
        "in_proj": dense_init(gen, lead + (d, 2 * di + 2 * g * n + h), d,
                              dtype),
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=dev),
        "A_log": a_log.expand(lead + (h,)).clone(),
        "D": torch.ones(lead + (h,), dtype=f32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(dt_u))),
        "norm": torch.ones(lead + (di,), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, lead + (di, d), di, dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_zxbcdt(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time, xbc (B, S, C), w (W, C): the W
    taps summed in f32 from zeros in order, then the bias, silu and the
    cast back to xbc's dtype."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + (pad[:, i:i + s].to(torch.float32)
                     * w[i].to(torch.float32))
    return silu(out + b.to(torch.float32)).to(xbc.dtype)


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    return xbc[..., :di], xbc[..., di:di + g * n], xbc[..., di + g * n:]


def ssd_chunked(cfg: ModelConfig, x, dt, A, bmat, cmat, init_state=None):
    """Chunked SSD scan. x (B, S, H, P), dt (B, S, H), A (H,) negative,
    bmat and cmat (B, S, G, N), each group broadcast over H // G heads.
    A sequence that is not a whole number of chunks of L = min(ssm_chunk,
    S) is padded at its tail with dt = 0 steps, which add nothing and keep
    the state. Returns (y (B, S, H, P) in x's dtype, the final f32 state
    (B, H, P, N))."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    L = min(cfg.ssm_chunk, s)
    s_orig = s
    if s % L:
        pad = L - s % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        s = s + pad
    nc, hg = s // L, h // g
    f32 = torch.float32
    xf = x.to(f32).reshape(b, nc, L, h, p)
    dtf = dt.to(f32).reshape(b, nc, L, h)
    bh = bmat.to(f32).reshape(b, nc, L, g, n).repeat_interleave(hg, dim=3)
    ch = cmat.to(f32).reshape(b, nc, L, g, n).repeat_interleave(hg, dim=3)

    cum = torch.cumsum(dtf * A, dim=2)  # (b, nc, L, h), within each chunk
    # att[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i; the
    # exponent is masked before exp: the j > i entries overflow to inf and
    # would poison the gradient through the select
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,Li,Lj,h)
    decay = torch.exp(torch.where(tri, diff, torch.full_like(diff, -1e30)))
    cb = torch.einsum("bclhn,bcmhn->bclmh", ch, bh)
    att = cb * decay * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", att, xf)

    # each chunk's end state: sum_j exp(cum_L - cum_j) dt_j B_j x_j^T
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bclh,bclhn,bclhp->bchpn", decay_to_end * dtf, bh,
                          xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, h)
    state = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    entering = []  # the state entering each chunk
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(entering, dim=1)  # (b, nc, h, p, n)
    y_inter = torch.einsum("bclhn,bchpn->bclhp",
                           ch * torch.exp(cum)[..., None], prev)
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), state


def _gated_out(cfg: ModelConfig, params, y: torch.Tensor, x: torch.Tensor,
               z: torch.Tensor, shape, dtype) -> torch.Tensor:
    """The D skip added in f32, the cast to the activation dtype, the
    gate ``y * silu(z)`` in that dtype, ``rms_norm`` and ``out_proj``."""
    d_skip = params["D"][:, None]
    y = y.to(torch.float32) + x.to(torch.float32) * d_skip
    y = y.reshape(shape).to(dtype)
    y = rms_norm(y * silu(z.to(torch.float32)).to(y.dtype), params["norm"],
                 cfg.rms_eps)
    return torch.einsum("bse,ed->bsd", y, params["out_proj"])


def mamba_train(cfg: ModelConfig, params, xin: torch.Tensor, *,
                return_cache: bool = False):
    """The full-sequence Mamba2 block, xin (B, S, D) -> (B, S, D); with
    ``return_cache`` also its serving cache: the final f32 SSM state and
    the last W - 1 raw (pre-conv) inputs of the conv, left-padded with
    zeros when S < W - 1."""
    b, s, _ = xin.shape
    h, p = cfg.ssm_nheads, cfg.ssm_headdim
    zxbcdt = torch.einsum("bsd,de->bse", xin, params["in_proj"])
    z, xbc_raw, dt = _split_zxbcdt(cfg, zxbcdt)
    xbc = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    x, bmat, cmat = _split_xbc(cfg, xbc)
    x = x.reshape(b, s, h, p)
    bmat = bmat.reshape(b, s, cfg.ssm_ngroups, cfg.ssm_state)
    cmat = cmat.reshape(b, s, cfg.ssm_ngroups, cfg.ssm_state)
    dt = _softplus(dt.to(torch.float32) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, final_state = ssd_chunked(cfg, x, dt, A, bmat, cmat)
    out = _gated_out(cfg, params, y, x, z, (b, s, cfg.d_inner), xin.dtype)
    if not return_cache:
        return out
    tail = cfg.ssm_conv - 1
    conv = (xbc_raw[:, s - tail:] if s >= tail
            else F.pad(xbc_raw, (0, 0, tail - s, 0)))
    return out, {"ssm": final_state, "conv": conv}


# ---------------------------------------------------------------------------
# Decode: constant-size recurrent state
# ---------------------------------------------------------------------------


def init_mamba_cache(cfg: ModelConfig, batch: int, device,
                     dtype: Optional[torch.dtype] = None) -> dict:
    """An empty cache: ``ssm`` f32 (B, H, P, N) and ``conv`` (B, W - 1,
    C) in ``dtype`` (default the activation dtype), on ``device``."""
    h, p, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    return {"ssm": torch.zeros((batch, h, p, n), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                 _conv_channels(cfg)),
                                dtype=dtype or cfg.act_dtype, device=device)}


def mamba_decode(cfg: ModelConfig, params, xin: torch.Tensor,
                 cache: dict):
    """One token, xin (B, 1, D): returns (out (B, 1, D), ``cache``, its
    ``ssm`` and ``conv`` written in place). The conv is the reference's
    einsum over the W taps of the history and the new input in f32 plus
    the bias; the history shifts by one through a new tensor (an
    overlapping in-place copy is undefined in torch)."""
    b = xin.shape[0]
    h, p, n, g = (cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
                  cfg.ssm_ngroups)
    zxbcdt = torch.einsum("bsd,de->bse", xin, params["in_proj"])
    z, xbc_t, dt = _split_zxbcdt(cfg, zxbcdt)
    conv_hist = torch.cat([cache["conv"], xbc_t.to(cache["conv"].dtype)],
                          dim=1)
    conv_out = torch.einsum("bwc,wc->bc", conv_hist.to(torch.float32),
                            params["conv_w"].to(torch.float32)) \
        + params["conv_b"].to(torch.float32)
    xbc = silu(conv_out)[:, None, :].to(xin.dtype)
    cache["conv"].copy_(conv_hist[:, 1:])
    x, bmat, cmat = _split_xbc(cfg, xbc)
    x = x.reshape(b, h, p)
    bh = bmat.reshape(b, g, n).repeat_interleave(h // g, dim=1)
    ch = cmat.reshape(b, g, n).repeat_interleave(h // g, dim=1)
    dt = _softplus(dt.to(torch.float32).reshape(b, h) + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A)  # (b, h)
    st = cache["ssm"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhn,bhp->bhpn", dt, bh.to(torch.float32), x.to(torch.float32))
    cache["ssm"].copy_(st)
    y = torch.einsum("bhn,bhpn->bhp", ch.to(torch.float32), st)
    out = _gated_out(cfg, params, y, x, z, (b, 1, cfg.d_inner), xin.dtype)
    return out, cache
