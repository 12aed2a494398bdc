"""The lane arithmetic of the warp's d_flow kernel
(``dbsr_tpu_torch/kernels/csrc/warp_bwd.cu``, ``dflow_kernel``), on the CPU.

A numpy model written to mirror the kernel step by step: the access width
(16 bytes where C divides it: 4 float32 or 8 bf16 channels; 8 bytes of bf16
where C % 4 == 0; else one channel), the L lanes of a pixel's segment (the
least power of two >= the channel groups, at most 32; 32 / L pixels a warp,
neighbours in the flat pixel order), the floor-tap geometry of
``tap_geometry`` in float32 with the derivative weights rounded to bf16 for
bf16 features, each lane's float32 sums over its groups sub, sub + L, ..
(channel by channel, the taps in order, by fmaf), the segmented butterfly of
``__shfl_xor_sync`` over log2(L) steps, and the write by the segment's first
lane. It must match ``warp_dflow_plain`` and the JAX package's Pallas
``_dflow_kernel`` in interpret mode: float32 within 1e-5 of the largest
value + 1e-6 (the sums run in another order), bf16 within 1e-5 of the
magnitude of the terms; on flows of +-5 px with taps on exact integers and on a frame whose every
tap is out of range (zeros). Every pixel is written exactly once, every
channel of a live pixel is read by exactly one lane, and no lane reads past
C.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.ops.warp_pallas import _warp_bwd_pallas
from dbsr_tpu_torch.ops import warp

RTOL, ATOL = 1e-5, 1e-6
BF16_RTOL = 1e-5  # of the magnitude of the terms
# frames 0 and 1 flows of +-5 px, frame 2 every tap out of range; 7 x 9 = 63
# pixels a frame, so that the last warp is part-filled at every L
SHAPE = (3, 7, 9)
CHANNELS = (1, 3, 5, 8, 24, 32, 48, 96, 128, 196, 512)
# with CHANNELS, one C for each (dtype, access width, L) the kernel has
MORE_CHANNELS = (2, 4, 12, 13, 16, 20, 33, 36)
# the Pallas d_flow alone (jit drops the d_feat kernel beside it)
pallas_dflow = jax.jit(
    lambda feat, flow, g: _warp_bwd_pallas(feat, flow, g, interpret=True)[1])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def round_bf16(a):
    """float32 values rounded to bf16 (nearest even) and widened back."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def access(C, dtype):
    """``run_dflow``'s channels an access."""
    wide = 4 if dtype == "float32" else 8
    if C % wide == 0:
        return wide
    return 4 if dtype == "bfloat16" and C % 4 == 0 else 1


def lanes(groups):
    """``launch_dflow_l``'s L: the least power of two >= ``groups``, at most
    32."""
    L = 1
    while L < min(groups, 32):
        L *= 2
    return L


def tap_geometry(flow, H, W):
    """``tap_geometry`` for the flow ``[B, P, 2]``: per pixel the clamped
    flat source of each floor tap (00, 01, 10, 11) in its frame and its
    derivatives along x and y, 0 out of range; float32 throughout."""
    f32 = np.float32
    p = np.arange(H * W)
    x = (p % W).astype(f32) + flow[..., 0]
    y = (p // W).astype(f32) + flow[..., 1]
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    ax, ay = f32(1) - wx, f32(1) - wy
    dxs, dys = (-ay, ay, -wy, wy), (-ax, -wx, ax, wx)
    q = np.empty(flow.shape[:-1] + (4,), np.int64)
    dx = np.empty(flow.shape[:-1] + (4,), f32)
    dy = np.empty_like(dx)
    for k in range(4):
        yi, xi = y0 + f32(k >> 1), x0 + f32(k & 1)
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        q[..., k] = (np.clip(yi, 0, H - 1).astype(np.int64) * W
                     + np.clip(xi, 0, W - 1).astype(np.int64))
        dx[..., k] = np.where(valid, dxs[k], f32(0))
        dy[..., k] = np.where(valid, dys[k], f32(0))
    return q, dx, dy


def fmaf(a, b, c):
    """float32 fused multiply-add: the float32 product is exact in float64,
    and the sum is rounded to float32 (through float64, which equals the
    single rounding of fmaf but in the rarest ties)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def model_dflow(feat, flow, g, dtype):
    """The kernel's d_flow ``[B, H, W, 2]`` of ``feat`` and ``g`` ``[B, H, W,
    C]`` (bf16 values held in float32 for ``dtype`` bfloat16) and ``flow``,
    with the writes per pixel, the reads of g per (pixel, channel) and the
    highest channel any lane read."""
    B, H, W, C = feat.shape
    P, total = H * W, B * H * W
    kvec = access(C, dtype)
    groups = C // kvec
    L = lanes(groups)
    lane = np.arange(32)
    sub = lane % L
    warps = -(-total // (32 // L))
    pix = np.arange(warps)[:, None] * (32 // L) + lane // L  # [warps, 32]
    live = pix < total
    pixc = np.minimum(pix, total - 1)
    q, dx, dy = tap_geometry(flow.reshape(B, P, 2), H, W)
    q = (q + (np.arange(B) * P)[:, None, None]).reshape(total, 4)[pixc]
    dx, dy = (d.reshape(total, 4)[pixc] for d in (dx, dy))
    if dtype == "bfloat16":  # operand(): the weights as bf16 operands
        dx, dy = round_bf16(dx), round_bf16(dy)
    use = (dx != 0) | (dy != 0)
    featf, gf = feat.reshape(total, C), g.reshape(total, C)
    sx = np.zeros(pix.shape, np.float32)
    sy = np.zeros(pix.shape, np.float32)
    g_reads = np.zeros((total, C), np.int64)
    top = -1
    for r in range(-(-groups // L)):
        j = sub + r * L
        on = live & (j < groups)
        for i in range(kvec):
            c = np.broadcast_to(j * kvec + i, pix.shape)
            cc = np.minimum(c, C - 1)
            np.add.at(g_reads, (pixc[on], c[on]), 1)
            top = max(top, int(c[on].max(initial=-1)))
            fx = np.zeros(pix.shape, np.float32)
            fy = np.zeros(pix.shape, np.float32)
            for k in range(4):
                v = featf[q[..., k], cc]
                fx = np.where(use[..., k], fmaf(dx[..., k], v, fx), fx)
                fy = np.where(use[..., k], fmaf(dy[..., k], v, fy), fy)
            gv = gf[pixc, cc]
            sx = np.where(on, fmaf(gv, fx, sx), sx)
            sy = np.where(on, fmaf(gv, fy, sy), sy)
    o = L // 2
    while o:  # each lane adds its partner's sum, lane ^ o
        sx, sy = sx + sx[:, lane ^ o], sy + sy[:, lane ^ o]
        o //= 2
    out = np.zeros((total, 2), np.float32)
    writes = np.zeros(total, np.int64)
    first = live & (sub == 0)
    out[pix[first]] = np.stack([sx[first], sy[first]], -1)
    np.add.at(writes, pix[first], 1)
    return out.reshape(B, H, W, 2), writes, g_reads, top


def _inputs(C, dtype, seed):
    rng = np.random.RandomState(seed)
    B, H, W = SHAPE
    flow = rng.uniform(-5, 5, (B, H, W, 2)).astype(np.float32)
    flow[:2, ::3] = np.round(flow[:2, ::3])  # taps on exact pixel centres
    flow[2] = 20.0  # every tap out of range
    feat = rng.randn(B, H, W, C).astype(np.float32)
    g = rng.randn(B, H, W, C).astype(np.float32)
    if dtype == "bfloat16":
        feat, g = round_bf16(feat), round_bf16(g)
    return feat, flow, g


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _terms(feat, flow, g):
    """The magnitude of d_flow's terms per pixel ``[B, H, W, 1]``: ``sum_c
    |g| sum_tap (|dw/dx| + |dw/dy|) |feat[tap]|``."""
    B, H, W, C = feat.shape
    fl = torch.from_numpy(flow)
    flat = torch.from_numpy(np.abs(feat)).reshape(B, H * W, C)
    acc = sum(warp._gather(flat, idx) * (dx.abs() + dy.abs())[..., None]
              for idx, _, dx, dy in warp._taps(warp.base_grid(H, W) + fl,
                                               H, W))
    return (acc * torch.from_numpy(np.abs(g))).sum(-1, keepdim=True).numpy()


def _check(got, want, feat, flow, g, dtype):
    """float32: within RTOL of the largest |want| + ATOL, the limit
    ``chip_smoke.py`` holds the kernel to (an element's own rtol fails where
    a sum of up to 512 products cancels); bf16: within BF16_RTOL of each
    element's terms."""
    if dtype == "float32":
        assert np.abs(got - want).max() <= RTOL * np.abs(want).max() + ATOL
    else:
        assert (np.abs(got - want)
                <= BF16_RTOL * _terms(feat, flow, g)).all()


def _model_checks(C, dtype, seed):
    """The model of ``(C, dtype)`` against the plain version, every pixel
    written once, every channel of every pixel read once, none past C, and
    zeros where every tap is out of range; returns the inputs and the
    model's output."""
    feat, flow, g = _inputs(C, dtype, seed)
    got, writes, g_reads, top = model_dflow(feat, flow, g, dtype)
    plain = warp.warp_dflow_plain(_torch(feat, dtype), torch.from_numpy(flow),
                                  _torch(g, dtype))
    assert plain.dtype == torch.float32
    _check(got, plain.numpy(), feat, flow, g, dtype)
    assert (writes == 1).all()
    assert (g_reads == 1).all() and top == C - 1
    assert not got[2].any()
    return feat, flow, g, got


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_matches_plain_and_pallas(dtype, C):
    feat, flow, g, got = _model_checks(C, dtype, 40 + C)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    pallas = pallas_dflow(jnp.asarray(feat).astype(jdt), jnp.asarray(flow),
                          jnp.asarray(g).astype(jdt))
    _check(got, np.asarray(pallas, np.float32), feat, flow, g, dtype)


@pytest.mark.parametrize("C", MORE_CHANNELS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_matches_plain_at_the_other_lane_widths(dtype, C):
    _model_checks(C, dtype, 60 + C)


@pytest.mark.parametrize("dtype, C, kvec, L", [
    ("bfloat16", 24, 8, 4), ("float32", 24, 4, 8),  # AlignLite's 48^2 level
    ("bfloat16", 48, 8, 8), ("float32", 48, 4, 16),  # its 24^2 level
    ("float32", 3, 1, 4), ("float32", 5, 1, 8),  # SCA's C = 3, an odd C
    ("bfloat16", 196, 4, 32), ("bfloat16", 512, 8, 32),
    ("float32", 512, 4, 32), ("bfloat16", 1, 1, 1)])
def test_dispatch_packs_pixels_by_c(dtype, C, kvec, L):
    assert (access(C, dtype), lanes(C // access(C, dtype))) == (kvec, L)


def test_the_channel_lists_take_every_instance():
    """CHANNELS and MORE_CHANNELS reach every (access width, L) that any C
    up to 600 reaches, in both dtypes (bf16's 8-byte access only at L in {1,
    4, 8, 16, 32}: two groups of 4 are 8 channels, a 16-byte access)."""
    for dtype in ("float32", "bfloat16"):
        def instances(cs):
            return {(access(c, dtype), lanes(c // access(c, dtype)))
                    for c in cs}
        assert instances(range(1, 601)) == instances(CHANNELS + MORE_CHANNELS)
