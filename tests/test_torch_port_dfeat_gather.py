"""The index arithmetic of the gather-form warp d_feat kernel
(``dbsr_tpu_torch/kernels/csrc/warp_bwd.cu``, ``dbsr_warp_dfeat_f32``), on
the CPU.

A numpy model written to mirror the kernel step by step: the floor-tap
geometry of ``tap_geometry`` in float32, the count of each target's
nonzero-weight taps, the exclusive scan into bucket starts, the fill of
(source, weight) pairs into the buckets in a given order of the sources
(the kernel's integer atomics hand out the slots in no fixed order), the
sort of each bucket by source (insertion sort, or heapsort for a bucket
of more than 32), and the gather that sums ``w * g[p]`` over
a bucket in ascending source order with fused multiply-adds into a
float32 sum. It must match ``warp_dfeat_plain`` and the JAX package's
Pallas ``_dfeat_kernel`` in interpret mode (rtol 1e-5 / atol 1e-6: the
sums run in another order) on flows of +-5 px with taps on exact
integers, on a flow whose every tap is out of range, and on a pile-up of
every source onto one pixel; and it must give the same bits whatever the
order in which the buckets were filled.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.ops.warp_pallas import _warp_bwd_pallas
from dbsr_tpu_torch.ops.warp import warp_dfeat_plain

RTOL, ATOL = 1e-5, 1e-6
SHAPE = (2, 12, 12, 8)
INSERTION_MAX = 32  # warp_bwd.cu: kInsertionMax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tap_geometry(flow, H, W):
    """``tap_geometry`` for one frame's flow ``[P, 2]``: per source pixel the
    clamped flat target of each floor tap (00, 01, 10, 11) and its weight,
    0 out of range; float32 throughout, as the kernel's ``__f*_rn``."""
    f32 = np.float32
    p = np.arange(H * W)
    x = (p % W).astype(f32) + flow[:, 0]
    y = (p // W).astype(f32) + flow[:, 1]
    x0, y0 = np.floor(x), np.floor(y)
    wx, wy = x - x0, y - y0
    ax, ay = f32(1) - wx, f32(1) - wy
    weights = (ay * ax, ay * wx, wy * ax, wy * wx)
    q = np.empty((H * W, 4), np.int64)
    w = np.empty((H * W, 4), f32)
    for k in range(4):
        yi, xi = y0 + f32(k >> 1), x0 + f32(k & 1)
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yc = np.clip(yi, 0, H - 1).astype(np.int64)
        xc = np.clip(xi, 0, W - 1).astype(np.int64)
        q[:, k] = yc * W + xc
        w[:, k] = np.where(valid, weights[k], f32(0))
    return q, w


def build_csr(q, w, fill_order):
    """Steps 1-4 of the kernel for one frame: count, exclusive scan, fill in
    ``fill_order`` of the sources, sort each bucket by source. Returns the
    bucket starts ``[P + 1]``, and each entry's source and weight."""
    P = q.shape[0]
    count = np.zeros(P, np.int64)
    for p in range(P):
        for k in range(4):
            if w[p, k] != 0:
                count[q[p, k]] += 1
    start = np.zeros(P + 1, np.int64)
    start[1:] = np.cumsum(count)
    cursor = np.zeros(P, np.int64)
    src = np.full(4 * P, -1, np.int64)
    wt = np.zeros(4 * P, np.float32)
    for p in fill_order:
        for k in range(4):
            if w[p, k] == 0:
                continue
            t = q[p, k]
            slot = start[t] + cursor[t]
            cursor[t] += 1
            src[slot], wt[slot] = p, w[p, k]
    for t in range(P):
        sort_bucket(src, wt, start[t], start[t + 1] - start[t])
    return start, src, wt


def sort_bucket(src, wt, lo, n):
    """``dfeat_sort_kernel`` on the bucket ``[lo, lo + n)``: insertion sort
    by source up to ``INSERTION_MAX`` entries, else heapsort."""
    def move(dst, frm):
        src[lo + dst], wt[lo + dst] = src[lo + frm], wt[lo + frm]

    if n <= INSERTION_MAX:
        for a in range(1, n):
            vs, vw = src[lo + a], wt[lo + a]
            b = a - 1
            while b >= 0 and src[lo + b] > vs:
                move(b + 1, b)
                b -= 1
            src[lo + b + 1], wt[lo + b + 1] = vs, vw
        return

    def sift_down(root, end):
        vs, vw = src[lo + root], wt[lo + root]
        while 2 * root + 1 < end:
            child = 2 * root + 1
            if child + 1 < end and src[lo + child + 1] > src[lo + child]:
                child += 1
            if src[lo + child] <= vs:
                break
            move(root, child)
            root = child
        src[lo + root], wt[lo + root] = vs, vw

    for root in range(n // 2 - 1, -1, -1):
        sift_down(root, n)
    for end in range(n - 1, 0, -1):
        top = src[lo], wt[lo]
        move(0, end)
        src[lo + end], wt[lo + end] = top
        sift_down(0, end)


def fmaf(a, b, c):
    """float32 fused multiply-add: the float32 product is exact in float64,
    and the sum is rounded to float32 (through float64, which equals the
    single rounding of fmaf but in the rarest ties)."""
    return (np.float64(a) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def gather(start, src, wt, g):
    """Step 5 for one frame ``g`` ``[P, C]``: each target's bucket in
    ascending source order, ``w * g[p]`` summed by fmaf from 0."""
    out = np.empty_like(g)
    for t in range(g.shape[0]):
        acc = np.zeros(g.shape[1], np.float32)
        for e in range(start[t], start[t + 1]):
            acc = fmaf(wt[e], g[src[e]], acc)
        out[t] = acc
    return out


def model_dfeat(flow, g, fill_order=None):
    """The kernel's d_feat of ``g`` ``[B, H, W, C]`` for ``flow``
    ``[B, H, W, 2]``, frame by frame; the sources fill their buckets in
    ``fill_order`` (ascending when None)."""
    B, H, W, C = g.shape
    P = H * W
    order = np.arange(P) if fill_order is None else fill_order
    out = np.empty_like(g)
    for b in range(B):
        q, w = tap_geometry(flow[b].reshape(P, 2), H, W)
        start, src, wt = build_csr(q, w, order)
        out[b] = gather(start, src, wt, g[b].reshape(P, C)).reshape(H, W, C)
    return out


def _flow(kind, rng):
    B, H, W, _ = SHAPE
    if kind == "pm5_with_integers":
        f = (rng.rand(B, H, W, 2) * 10 - 5).astype(np.float32)
        f[:, ::3] = np.round(f[:, ::3])  # taps on exact pixel centres
        return f
    if kind == "all_out_of_range":
        return np.full((B, H, W, 2), 20.0, np.float32)
    if kind == "pile_up":  # every source onto pixel (5.25, 7.5)
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        f = np.stack([5.25 - xs, 7.5 - ys], -1).astype(np.float32)
        return np.broadcast_to(f, (B, H, W, 2)).copy()
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["pm5_with_integers", "all_out_of_range",
                                  "pile_up"])
def test_gather_model_matches_plain_and_pallas(kind):
    rng = np.random.RandomState(30)
    flow = _flow(kind, rng)
    g = rng.randn(*SHAPE).astype(np.float32)
    got = model_dfeat(flow, g)
    plain = warp_dfeat_plain(torch.from_numpy(flow),
                             torch.from_numpy(g)).numpy()
    feat = rng.randn(*SHAPE).astype(np.float32)  # d_feat does not read it
    pallas, _ = _warp_bwd_pallas(jnp.array(feat), jnp.array(flow),
                                 jnp.array(g), interpret=True)
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=RTOL, atol=ATOL)
    if kind == "all_out_of_range":
        assert not got.any()
    if kind == "pile_up":  # one target holds every source's tap
        P = SHAPE[1] * SHAPE[2]
        q, w = tap_geometry(flow[0].reshape(P, 2), *SHAPE[1:3])
        start, _, _ = build_csr(q, w, np.arange(P))
        assert (np.diff(start) == P).sum() == 4  # the 4 taps of (5.25, 7.5)
    # the slots' order does not reach the sums: the same bits from a
    # reversed and from a shuffled fill
    P = SHAPE[1] * SHAPE[2]
    for order in (np.arange(P)[::-1], rng.permutation(P)):
        assert np.array_equal(model_dfeat(flow, g, order).view(np.uint32),
                              got.view(np.uint32))


@pytest.mark.parametrize("channels", [1, 3, 5])
def test_gather_model_at_c_not_a_multiple_of_4(channels):
    """The kernel's path for C % 4 != 0 (SCA's 3-channel warp) gathers one
    channel a thread in the same bucket order: the model at C in {1, 3, 5}
    against the plain version, and the same bits from any fill order."""
    rng = np.random.RandomState(31)
    shape = SHAPE[:3] + (channels,)
    f = (rng.rand(*shape[:3], 2) * 16 - 8).astype(np.float32)
    f[:, ::3] = np.round(f[:, ::3])
    g = rng.randn(*shape).astype(np.float32)
    got = model_dfeat(f, g)
    plain = warp_dfeat_plain(torch.from_numpy(f), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, plain, rtol=RTOL, atol=ATOL)
    P = shape[1] * shape[2]
    assert np.array_equal(
        model_dfeat(f, g, rng.permutation(P)).view(np.uint32),
        got.view(np.uint32))
