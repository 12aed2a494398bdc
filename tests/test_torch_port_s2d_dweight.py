"""The weight gradient of the s2d decoder's fine 3x3 conv
(``ops/conv_s2d.py:conv3x3_s2d_dweight``) on the CPU.

* ``conv3x3_s2d_dweight_plain`` against ``torch.nn.grad.conv2d_weight`` of
  the unfolded tensors in float64, at odd channel counts, ragged planes and
  on bf16-valued operands; against ``jax.vjp`` of the fine-resolution conv;
  and the adjoint identity <conv(x, w), g> = <w, dweight(x, g)> in float64.
* ``Conv3x3S2D`` on CPU tensors takes the plain version and leaves the
  kernel's counter alone; a tensor off the CPU launches or raises.
* A numpy model of ``kernels/csrc/conv_s2d_dweight.cu``: the jobs cut among
  the blocks, the staging rings and their slots (unstaged shared memory
  reads NaN), ``ldmatrix.trans`` and the ``mma.sync.m16n8k16`` fragments
  lane by lane, the two row warps' combine, the partials' layout and the
  reduction, against the plain version; its sizes read out of the kernel's
  source.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu_torch.models.layers import depth_to_space_phase_major
from dbsr_tpu_torch.ops import conv_s2d
from dbsr_tpu_torch.ops.conv_s2d import (conv3x3_s2d, conv3x3_s2d_dweight,
                                         conv3x3_s2d_dweight_plain,
                                         conv3x3_s2d_plain)

BF = torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(seed, B, H2, W2, C, O, bf16=False):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, H2, W2, 4 * C).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, H2, W2, 4 * O).astype(np.float32))
    if bf16:
        x, g = x.to(BF), g.to(BF)
    return x, g


def _unfolded_dweight(x, g, O, C):
    """float64 ``conv2d_weight`` of the unfolded operands."""
    def nchw(t):
        return depth_to_space_phase_major(t.double(), 2).permute(0, 3, 1, 2)
    return torch.nn.grad.conv2d_weight(nchw(x), (O, C, 3, 3), nchw(g),
                                       padding=1)


# (B, H2, W2, C, O): the decoder's C = O = 32; odd channel counts; ragged
# planes, a 1-row plane, more than 32 channels
SHAPES = [(2, 4, 4, 32, 32), (1, 3, 5, 3, 5), (2, 5, 3, 7, 7),
          (1, 4, 6, 33, 5), (1, 1, 9, 5, 33), (1, 3, 17, 16, 8)]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_equals_conv2d_weight_of_the_unfolded_tensors(shape, bf16):
    B, H2, W2, C, O = shape
    x, g = _operands(sum(shape), *shape, bf16=bf16)
    got = conv3x3_s2d_dweight_plain(x, g, (O, C, 3, 3))
    assert got.shape == (O, C, 3, 3) and got.dtype == torch.float32
    want = _unfolded_dweight(x, g, O, C)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0,
                               atol=2e-6 * float(want.abs().max()))


@pytest.mark.parametrize("shape", [(2, 8, 8, 32, 32), (2, 3, 5, 16, 24)])
def test_plain_matches_jax_vjp_of_the_fine_conv(shape):
    B, H2, W2, C, O = shape
    x, g = _operands(7, *shape)
    k = np.random.RandomState(8).randn(3, 3, C, O).astype(np.float32)

    def fine_conv(kk):
        return jax.lax.conv_general_dilated(
            jnp.asarray(depth_to_space_phase_major(x, 2).numpy()), kk,
            (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=jax.lax.Precision.HIGHEST)

    (want,) = jax.vjp(fine_conv, jnp.asarray(k))[1](
        jnp.asarray(depth_to_space_phase_major(g, 2).numpy()))
    got = conv3x3_s2d_dweight_plain(x, g, (O, C, 3, 3))
    want = np.asarray(want).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 4, 6, 5, 7), (1, 3, 3, 32, 32)])
def test_adjoint_identity_in_float64(shape):
    """<conv(x, w), g> = <w, dweight(x, g)>, both sides in float64."""
    B, H2, W2, C, O = shape
    x, g = (t.double() for t in _operands(3, *shape))
    w = torch.from_numpy(np.random.RandomState(4).randn(O, C, 3, 3))
    lhs = float((conv3x3_s2d_plain(x, w) * g).sum())
    dk = conv3x3_s2d_dweight_plain(x, g, (O, C, 3, 3))
    assert dk.dtype == torch.float64
    rhs = float((w * dk).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_function_on_cpu_takes_the_plain_version_uncounted(dtype,
                                                           monkeypatch):
    x, g = _operands(5, 1, 4, 4, 8, 6)
    x = x.to(dtype).requires_grad_(True)
    w = torch.from_numpy(
        np.random.RandomState(6).randn(6, 8, 3, 3).astype(np.float32)
    ).requires_grad_(True)
    calls = []
    plain = conv_s2d.conv3x3_s2d_dweight_plain
    monkeypatch.setattr(conv_s2d, "conv3x3_s2d_dweight_plain",
                        lambda *a: calls.append(1) or plain(*a))
    before = conv3x3_s2d_dweight.launches
    conv3x3_s2d(x, w).backward(g.to(dtype))
    assert calls == [1]
    assert conv3x3_s2d_dweight.launches == before
    assert w.grad.dtype == torch.float32
    want = plain(x.detach(), g.to(dtype), (6, 8, 3, 3))
    torch.testing.assert_close(w.grad, want, rtol=0, atol=0)


def test_cuda_requests_raise_without_falling_back():
    """A tensor off the CPU launches the kernel or raises; shapes that do
    not fit raise before."""
    x = torch.empty(1, 4, 4, 16, dtype=BF, device="meta")
    g = torch.empty(1, 4, 4, 32, dtype=BF, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        conv3x3_s2d_dweight(x, g, (8, 4, 3, 3))
    with pytest.raises(ValueError, match=r"\[O,C,3,3\]"):
        conv3x3_s2d_dweight(torch.zeros(1, 4, 4, 16), torch.zeros(1, 4, 4, 32),
                            (8, 5, 3, 3))
    with pytest.raises(ValueError, match=r"\[B,H2,W2,4O\]"):
        conv3x3_s2d_dweight(torch.zeros(1, 4, 4, 16), torch.zeros(1, 4, 5, 32),
                            (8, 4, 3, 3))


# ---------------------------------------------------------------------------
# a numpy model of kernels/csrc/conv_s2d_dweight.cu

K_STRIP_X, K_FINE_W, K_HALO_W, K_PIX = 16, 32, 34, 40
K_DEPTH = 3
K_XSLOTS, K_GSLOTS = K_DEPTH + 3, K_DEPTH + 1
K_TAPS, K_PARTIAL = 9, 32 * 9 * 32
LANES = np.arange(32)


def _stage_x(dst, xb, Yr, X0, H2, W2, C, c0, vec):
    """``stage_x``: dst [2, 34, 40] of one slot; xb [H2*W2*4C] flat."""
    row_in = 0 <= Yr < H2
    if vec:
        for i in range((K_STRIP_X + 2) * 16):
            ch, q, X = i & 3, (i >> 2) & 3, X0 - 1 + (i >> 4)
            j = 2 * (X - X0) + (q & 1) + 1
            if j < 0 or j >= K_HALO_W:
                continue
            c = c0 + ch * 8
            ok = row_in and 0 <= X < W2 and c < C
            base = ((Yr * W2 + X) * 4 * C + q * C + c) if ok else 0
            dst[q >> 1, j, ch * 8:ch * 8 + 8] = (
                xb[base:base + 8] if ok else 0.0)
    else:
        for i in range((K_STRIP_X + 2) * 4 * 32):
            cl, q, X = i & 31, (i // 32) & 3, X0 - 1 + i // 128
            j = 2 * (X - X0) + (q & 1) + 1
            if j < 0 or j >= K_HALO_W:
                continue
            c = c0 + cl
            ok = row_in and 0 <= X < W2 and c < C
            dst[q >> 1, j, cl] = (xb[(Yr * W2 + X) * 4 * C + q * C + c]
                                  if ok else 0.0)


def _stage_g(dst, gb, Y, X0, W2, O, o0, vec):
    """``stage_g``: dst [2, 32, 40] of one slot."""
    if vec:
        for i in range(K_STRIP_X * 16):
            ch, q, X = i & 3, (i >> 2) & 3, X0 + (i >> 4)
            j = 2 * (X - X0) + (q & 1)
            o = o0 + ch * 8
            ok = X < W2 and o < O
            base = ((Y * W2 + X) * 4 * O + q * O + o) if ok else 0
            dst[q >> 1, j, ch * 8:ch * 8 + 8] = (
                gb[base:base + 8] if ok else 0.0)
    else:
        for i in range(K_STRIP_X * 4 * 32):
            ol, q, X = i & 31, (i // 32) & 3, X0 + i // 128
            j = 2 * (X - X0) + (q & 1)
            o = o0 + ol
            ok = X < W2 and o < O
            dst[q >> 1, j, ol] = (gb[(Y * W2 + X) * 4 * O + q * O + o]
                                  if ok else 0.0)


def _ldmatrix_x4_trans(flat, addrs):
    """``ldmatrix...x4.trans``: lane L gives the row address of matrix L/8,
    row L%8 (8 consecutive elements of ``flat``); each lane's register i
    holds (stored row 2*(T%4), column T/4) and (row 2*(T%4)+1, column T/4)
    of matrix i. Returns [4 regs, 32 lanes, 2]."""
    rows = flat[addrs[:, None] + np.arange(8)]        # [32 lanes, 8]
    regs = np.empty((4, 32, 2), np.float32)
    for i in range(4):
        mat = rows[8 * i:8 * i + 8]                    # [row, col]
        regs[i, :, 0] = mat[2 * (LANES % 4), LANES // 4]
        regs[i, :, 1] = mat[2 * (LANES % 4) + 1, LANES // 4]
    return regs


def _mma(a, b0, b1, c=None):
    """``mma.sync.m16n8k16.row.col``: a [4, 32, 2] (a0..a3 per lane), b0,
    b1 [32, 2]; d = A B (+ c) per lane as [32, 4] (sums in float64, rounded
    once: the tensor core's truncation is not modelled)."""
    g8, t4 = LANES // 4, LANES % 4
    A = np.zeros((16, 16))
    Bm = np.zeros((16, 8))
    for e in range(2):
        A[g8, 2 * t4 + e] = a[0, :, e]
        A[g8 + 8, 2 * t4 + e] = a[1, :, e]
        A[g8, 2 * t4 + 8 + e] = a[2, :, e]
        A[g8 + 8, 2 * t4 + 8 + e] = a[3, :, e]
        Bm[2 * t4 + e, g8] = b0[:, e]
        Bm[2 * t4 + 8 + e, g8] = b1[:, e]
    D = A @ Bm
    d = np.stack([D[g8, 2 * t4], D[g8, 2 * t4 + 1], D[g8 + 8, 2 * t4],
                  D[g8 + 8, 2 * t4 + 1]], axis=1)
    if c is not None:
        d = d + c
    return d.astype(np.float32)


def _compute_job(i, s_x, s_g, acc):
    """One job's MMAs for the 8 warps, as the kernel's loop body."""
    mi, r8 = LANES >> 3, LANES & 7
    sx = s_x.reshape(K_XSLOTS, -1)
    sg = s_g.reshape(K_GSLOTS, -1)
    for warp in range(8):
        nt, p = warp & 3, warp >> 2
        gs = sg[i % K_GSLOTS]
        gbase = p * K_FINE_W * K_PIX
        a = [[_ldmatrix_x4_trans(
            gs, gbase + (h * 16 + (mi >> 1) * 8 + r8) * K_PIX
            + (m * 2 + (mi & 1)) * 8) for m in range(2)] for h in range(2)]
        for ky in range(3):
            rr = p + ky - 1
            xs = sx[(i + 1 + (rr >> 1)) % K_XSLOTS]
            xbase = (rr & 1) * K_HALO_W * K_PIX
            for kx in range(3):
                bx = _ldmatrix_x4_trans(
                    xs, xbase + ((mi >> 1) * 16 + (mi & 1) * 8 + r8 + kx)
                    * K_PIX + nt * 8)
                for m in range(2):
                    step = _mma(a[0][m], bx[0], bx[1])
                    step = _mma(a[1][m], bx[2], bx[3], step)
                    t = ky * 3 + kx
                    acc[warp, :, m, t] = (acc[warp, :, m, t]
                                          + step).astype(np.float32)


def _dweight_kernel_model(x, g, O, C, G):
    B, H2, W2 = x.shape[:3]
    x = x.reshape(B, -1)
    g = g.reshape(B, -1)
    n_cb, n_ob = -(-C // 32), -(-O // 32)
    strips = -(-W2 // K_STRIP_X)
    jobs = B * strips * H2
    partial = np.full((n_cb * n_ob, G, K_PARTIAL), np.nan, np.float32)
    for by in range(n_cb * n_ob):
        cb = by // n_ob
        c0, o0 = cb * 32, (by - cb * n_ob) * 32
        for bx in range(G):
            # unstaged shared memory reads NaN
            s_x = np.full((K_XSLOTS, 2, K_HALO_W, K_PIX), np.nan, np.float32)
            s_g = np.full((K_GSLOTS, 2, K_FINE_W, K_PIX), np.nan, np.float32)
            acc = np.zeros((8, 32, 2, K_TAPS, 4), np.float32)
            J, j_end = jobs * bx // G, jobs * (bx + 1) // G
            while J < j_end:
                s = J // H2
                Ya = J - s * H2
                n = min(H2 - Ya, j_end - J)
                b = s // strips
                X0 = (s - b * strips) * K_STRIP_X

                def stage(k, b=b, X0=X0, Ya=Ya, n=n):
                    if k < n:
                        _stage_x(s_x[(k + 2) % K_XSLOTS], x[b], Ya + 1 + k,
                                 X0, H2, W2, C, c0, C % 8 == 0)
                        _stage_g(s_g[k % K_GSLOTS], g[b], Ya + k, X0, W2, O,
                                 o0, O % 8 == 0)

                for m in range(2):
                    _stage_x(s_x[m], x[b], Ya - 1 + m, X0, H2, W2, C, c0,
                             C % 8 == 0)
                for k in range(K_DEPTH):
                    stage(k)
                for i in range(n):
                    stage(i + K_DEPTH)
                    _compute_job(i, s_x, s_g, acc)
                J += n
            # the combine: row 1's warps through shared memory, then row 0's
            s_acc = np.full(K_PARTIAL, np.nan, np.float32)
            for warp in range(4, 8):
                nt = warp & 3
                for m in range(2):
                    for t in range(K_TAPS):
                        for k2 in range(4):
                            s_acc[(((m * K_TAPS + t) * 4 + k2) * 4 + nt) * 32
                                  + LANES] = acc[warp, :, m, t, k2]
            pb = partial[by, bx]
            g8, t4 = LANES >> 2, LANES & 3
            for nt in range(4):
                for m in range(2):
                    for t in range(K_TAPS):
                        for hi in range(2):
                            o = m * 16 + g8 + 8 * hi
                            other = (((m * K_TAPS + t) * 4 + 2 * hi) * 4
                                     + nt) * 32 + LANES
                            v0 = acc[nt, :, m, t, 2 * hi] + s_acc[other]
                            v1 = acc[nt, :, m, t, 2 * hi + 1] \
                                + s_acc[other + 4 * 32]
                            idx = (o * K_TAPS + t) * 32 + nt * 8 + 2 * t4
                            pb[idx] = v0
                            pb[idx + 1] = v1
    # the reduction: grid (288, n_cb * n_ob), 8 groups of 32 lanes
    out = np.full((O, C, K_TAPS), np.nan, np.float32)
    for by in range(n_cb * n_ob):
        cb = by // n_ob
        for blk in range(32 * K_TAPS):
            sums = [partial[by][grp::8][:, blk * 32 + LANES].astype(
                np.float64).sum(0) for grp in range(8)]
            total = np.sum(sums, axis=0)
            o = (by - cb * n_ob) * 32 + blk // K_TAPS
            c = cb * 32 + LANES
            if o < O:
                out[o, c[c < C], blk % K_TAPS] = total[c < C]
    return out.reshape(O, C, 3, 3)


# (B, H2, W2, C, O, blocks): the decoder's channels; odd channel counts
# (the plain loads); a ragged strip; two channel blocks each way; more
# blocks than jobs; one block over several strips and images
MODEL_CASES = [(1, 4, 8, 32, 32, 3), (1, 3, 5, 5, 7, 2), (2, 2, 17, 8, 16, 5),
               (1, 2, 3, 33, 40, 2), (1, 1, 2, 8, 8, 4), (2, 3, 20, 16, 3, 1)]


@pytest.mark.parametrize("case", MODEL_CASES)
def test_kernel_model_matches_the_plain_version(case):
    B, H2, W2, C, O, G = case
    x, g = _operands(sum(case), B, H2, W2, C, O, bf16=True)
    jobs = B * H2 * -(-W2 // 16)
    got = _dweight_kernel_model(x.float().numpy(), g.float().numpy(), O, C,
                                max(1, min(jobs, G)))
    assert np.isfinite(got).all()
    want = _unfolded_dweight(x, g, O, C).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_model_sizes_are_the_kernels():
    """The model's sizes are the ones ``conv_s2d_dweight.cu`` is built
    with: its strip, staged pixel, ring depths, taps, warps, partial and
    reduce groups."""
    src = (Path(conv_s2d.__file__).parents[1] / "kernels" / "csrc"
           / "conv_s2d_dweight.cu").read_text()
    k = {}
    for name, expr in re.findall(r"constexpr int (k\w+) = ([^;]+);", src):
        k[name] = eval(expr, {}, dict(k))
    assert (k["kStripX"], k["kFineW"], k["kHaloW"], k["kPix"]) == (
        K_STRIP_X, K_FINE_W, K_HALO_W, K_PIX)
    assert (k["kDepth"], k["kXSlots"], k["kGSlots"]) == (
        K_DEPTH, K_XSLOTS, K_GSLOTS)
    assert (k["kTaps"], k["kPartial"], k["kCB"], k["kOB"]) == (
        K_TAPS, K_PARTIAL, 32, 32)
    assert (k["kThreads"] // 32, k["kReduceGroups"]) == (8, 8)
