"""The cost volume's backward in the form of its CUDA kernel
(``dbsr_tpu_torch/kernels/csrc/correlation_bwd.cu``), on the CPU.

d_second there is d_first's sum with the operand's displacement mirrored,
over the gradient shifted per output pixel, ``G'[v, w, o] = g[v-dy_o,
w-dx_o, o]``. ``correlation_dsecond_shifted_plain`` computes it in that
form; it must match ``correlation_dsecond_plain``, the Pallas body
``_corr_dsecond_kernel`` in interpret mode (planes <= 16x16, that kernel's
envelope) and ``jax.vjp`` of the XLA formulation (larger planes).

A numpy model mirrors the kernel's walk with its own tile constants (read
back from the source): the 8x12 output tile and its +-4 halo, the channel
groups and chunks, the split of the chunks across blocks, the staging of
g (d_first) or of G' from g's halo rows (d_second), the register tile's
taps (mirrored for d_second) in ascending displacement order with fused
multiply-adds, and the stores; g staged by 16-byte copies where W % 4 == 0
(the 48, 24 and 12 wide levels) and by 4-byte ones on the 13x22 plane. For both gradients it must match the plain
versions, write every output element exactly once, and fill every G' slot
exactly once. It also checks that the staged operand's 16-byte loads of 8
consecutive threads fall on 8 distinct bank quads for every channel-group
count.

Tolerances: the shifted form against the plain version, Pallas and JAX
rtol 1e-5 / atol 1e-6 per element (an 81-term float32 sum in another
order). The model's sums are fused multiply-adds, as the kernel's, and the
plain versions round each product: where the 81 terms cancel (C=1, no 1/C
scale), that moves an output by an ulp of the terms' size, ~1e-6 on an
output of ~0.03. So the model is held to the plain versions as
``chip_smoke.py`` holds the kernel: max error <= 1e-5 max|plain| + 1e-6.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.ops.correlation import (_correlation_pallas_bwd_impl,
                                      correlation_xla)
from dbsr_tpu_torch.ops.correlation import (correlation_dfirst_plain,
                                            correlation_dsecond_plain,
                                            correlation_dsecond_shifted_plain,
                                            shift_gradient)

RTOL, ATOL = 1e-5, 1e-6
CU = (Path(__file__).resolve().parents[1] / "dbsr_tpu_torch" / "kernels"
      / "csrc" / "correlation_bwd.cu")

# the kernel's constants (checked against the source below)
R, D, OFF = 4, 9, 81
K, TY, NG, MAX_CG = 4, 8, 3, 8
TARGET_BLOCKS = 8 * 132
TX = NG * K
TILE = TY * TX
PG = TY * NG
HY, HX = TY + 2 * R, TX + 2 * R
MAX_SMEM = 227 * 1024

# the three AlignLite levels at small B, and a ragged 13x22 plane at odd C
LEVELS = [(2, 12, 12, 96), (1, 24, 24, 48), (1, 48, 48, 24)]
RAGGED = [(2, 13, 22, c) for c in (1, 3, 5, 33, 136)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    first = rng.randn(*shape).astype(np.float32)
    second = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape[:3], OFF).astype(np.float32)
    return first, second, g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _close_as_kernel(got, want):
    """``chip_smoke.py``'s ``check_close``: the largest error against the
    largest value."""
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= RTOL * np.abs(want).max() + ATOL, err


# ---------------------------------------------------------------------------
# the shifted form


@pytest.mark.parametrize("shape", LEVELS + RAGGED)
def test_shifted_dsecond_matches_plain(shape):
    first, _, g = _inputs(shape, 40)
    _close(correlation_dsecond_shifted_plain(_t(first), _t(g)),
           correlation_dsecond_plain(_t(first), _t(g)))


def test_shift_gradient_moves_each_value_to_its_target():
    """``G'[v, w, o] = g[v-dy_o, w-dx_o, o]``, zero where that read falls
    outside the plane."""
    _, _, g = _inputs((1, 7, 10, 1), 41)
    gs = shift_gradient(_t(g)).numpy()
    for o in range(OFF):
        dy, dx = o // D - R, o % D - R
        for v in range(7):
            for w in range(10):
                y, x = v - dy, w - dx
                want = g[0, y, x, o] if 0 <= y < 7 and 0 <= x < 10 else 0.0
                assert gs[0, v, w, o] == want


@pytest.mark.parametrize("shape", [(2, 12, 12, 96), (1, 16, 9, 8)])
def test_shifted_dsecond_matches_pallas_interpret(shape):
    first, second, g = _inputs(shape, 42)
    _, want = _correlation_pallas_bwd_impl(
        jnp.array(first), jnp.array(second), jnp.array(g), interpret=True)
    _close(correlation_dsecond_shifted_plain(_t(first), _t(g)), want)


@pytest.mark.parametrize("shape", [(1, 24, 24, 48), (1, 48, 48, 24),
                                   (2, 13, 22, 33)])
def test_shifted_dsecond_matches_jax_vjp(shape):
    first, second, g = _inputs(shape, 43)
    _, vjp = jax.vjp(correlation_xla, jnp.array(first), jnp.array(second))
    _, want = vjp(jnp.array(g))
    _close(correlation_dsecond_shifted_plain(_t(first), _t(g)), want)


# ---------------------------------------------------------------------------
# a numpy model of the kernel


def test_model_constants_are_the_kernels():
    src = CU.read_text()
    consts = dict(re.findall(r"constexpr (?:int|long long) (k\w+) = ([^;]+);",
                             src))
    assert {k: consts[k] for k in ("kR", "kK", "kTY", "kNG", "kMaxCG",
                                   "kTargetBlocks")} == {
        "kR": str(R), "kK": str(K), "kTY": str(TY), "kNG": str(NG),
        "kMaxCG": str(MAX_CG), "kTargetBlocks": "8 * 132"}
    assert "constexpr size_t kMaxSmem = 227 * 1024;" in src


def groups_of(c4):
    """The kernel's ``groups_of``: 4-channel groups per chunk."""
    if c4 <= MAX_CG:
        return c4
    return min(range(MAX_CG, 3, -1), key=lambda n: (-(-c4 // n) * n, -n))


def row_stride(ncg):
    """The kernel's ``row_stride``: float4s per staged halo row."""
    return HX * ncg + (ncg - HX * ncg) % 8


def plan(frames, H, W, C):
    c4 = -(-C // 4)
    ncg = groups_of(c4)
    chunks = -(-c4 // ncg)
    tiles_x = -(-W // TX)
    tiles = -(-H // TY) * tiles_x
    blocks = tiles * frames
    splits = min(-(-TARGET_BLOCKS // blocks), chunks)
    per = -(-chunks // splits)
    smem = (2 if per > 1 else 1) * HY * row_stride(ncg) * 16 + TILE * OFF * 4
    return dict(ncg=ncg, chunks=chunks, tiles_x=tiles_x, tiles=tiles,
                blocks=blocks, splits=splits, smem=smem)


def _fma(a, b, c):
    """float32 fused multiply-add (the product exact in float64)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _pair(q):
    """The kernel's pair ``q`` of G''s fill: (source column hx, dx + R), the
    pairs whose output column hx + dx - R lies in the tile, by hx then dx."""
    hx, rest = 0, q
    while True:
        lo = max(0, 2 * R - hx)
        n = min(D - 1, TX - 1 + 2 * R - hx) - lo + 1
        if rest < n:
            return hx, lo + rest
        rest -= n
        hx += 1


def _stage_g(g, ty0, tx0, shifted):
    """g on the tile (d_first) or G' (d_second) as the kernel stages them,
    ``[TILE, 81]``; every slot written once (checked)."""
    H, W = g.shape[:2]
    s_g = np.zeros(TILE * OFF, np.float32)
    count = np.zeros(TILE * OFF, np.int64)
    if not shifted:
        # each tile row's values, contiguous in g: 16-byte copies (4 values,
        # those past the plane zero-filled) when W % 4 == 0, else 4-byte ones
        nx = min(TX, W - tx0) * OFF
        ny = min(TY, H - ty0)
        rows = g.reshape(H, W * OFF)
        step = 4 if W % 4 == 0 else 1
        for i in range(0, TILE * OFF, step):
            tr, e = divmod(i, TX * OFF)
            n = max(0, min(step, nx - e)) if tr < ny else 0
            row = tx0 * OFF + e
            s_g[i:i + n] = rows[ty0 + tr, row:row + n] if n else 0
            count[i:i + step] += 1
    else:
        # thread q's pair (hx, dx), then every (tile row, dy)
        for q in range(TX * D):
            hx, dxi = _pair(q)
            tc = hx + dxi - 2 * R
            assert 0 <= tc < TX
            x = tx0 + hx - R
            for tr in range(TY):
                for dyi in range(D):
                    y = ty0 + tr + R - dyi
                    o = dyi * D + dxi
                    dst = (tr * TX + tc) * OFF + o
                    if 0 <= x < W and 0 <= y < H:
                        s_g[dst] = g[y, x, o]
                    count[dst] += 1
    assert (count == 1).all(), "a g slot filled other than once"
    return s_g.reshape(TILE, OFF)


def _stage_operand(op, ty0, tx0, c0, ncg):
    """Channels c0.. (ncg groups of 4) of the halo'd tile, zero outside the
    plane and past C: ``[HY, HX, ncg, 4]``."""
    H, W, C = op.shape
    st = np.zeros((HY, HX, ncg * 4), np.float32)
    ys = slice(max(ty0 - R, 0), min(ty0 - R + HY, H))
    xs = slice(max(tx0 - R, 0), min(tx0 - R + HX, W))
    cs = slice(c0, min(c0 + ncg * 4, C))
    st[ys.start - (ty0 - R):ys.stop - (ty0 - R),
       xs.start - (tx0 - R):xs.stop - (tx0 - R),
       :cs.stop - cs.start] = op[ys, xs, cs]
    return st.reshape(HY, HX, ncg, 4)


def kernel_model(operand, g, shifted):
    """``correlation_bwd.cu`` in numpy: d_first (``shifted`` False, operand
    ``second``) or d_second (True, operand ``first``); returns the gradient
    and the count of writes of each element."""
    B, H, W, C = operand.shape
    p = plan(B, H, W, C)
    ncg = p["ncg"]
    assert p["smem"] <= MAX_SMEM
    out = np.full(operand.shape, np.nan, np.float32)
    writes = np.zeros(operand.shape, np.int64)
    inv = np.float32(1.0) / np.float32(C)
    t = np.arange(PG * ncg)
    cg, pg = t % ncg, t // ncg
    r, gx = pg % TY, pg // TY * K
    for block in range(p["blocks"]):
        frame, tile = divmod(block, p["tiles"])
        ty0 = tile // p["tiles_x"] * TY
        tx0 = tile % p["tiles_x"] * TX
        s_g = _stage_g(g[frame], ty0, tx0, shifted)
        for split in range(p["splits"]):
            for k in range(split, p["chunks"], p["splits"]):
                st = _stage_operand(operand[frame], ty0, tx0, k * ncg * 4,
                                    ncg)
                acc = np.zeros((t.size, K, 4), np.float32)
                for iy in range(D):
                    hy = r + 2 * R - iy if shifted else r + iy
                    for jj in range(K + 2 * R):
                        j = K + 2 * R - 1 - jj if shifted else jj
                        b = st[hy, gx + j, cg]
                        for i in range(K):
                            dxi = i - j + 2 * R if shifted else j - i
                            if 0 <= dxi < D:
                                gv = s_g[r * TX + gx + i, iy * D + dxi]
                                acc[:, i] = _fma(gv[:, None], b, acc[:, i])
                c = (k * ncg + cg) * 4
                y = ty0 + r
                for i in range(K):
                    x = tx0 + gx + i
                    for e in range(4):
                        ok = (y < H) & (x < W) & (c + e < C)
                        out[frame, y[ok], x[ok], c[ok] + e] = \
                            acc[ok, i, e] * inv
                        np.add.at(writes[frame], (y[ok], x[ok], c[ok] + e), 1)
    return out, writes


@pytest.mark.parametrize("shifted", [False, True], ids=["dfirst", "dsecond"])
@pytest.mark.parametrize("shape", LEVELS + RAGGED)
def test_kernel_model_matches_plain(shape, shifted):
    first, second, g = _inputs(shape, 44)
    operand = first if shifted else second
    got, writes = kernel_model(operand, g, shifted)
    assert (writes == 1).all(), "an output element written other than once"
    plain = correlation_dsecond_plain if shifted else correlation_dfirst_plain
    _close_as_kernel(got, plain(_t(operand), _t(g)))


def test_kernel_plan_at_alignlite_levels():
    """The main path's launches: 112 frames at each level; channel groups
    padding nothing, every main-path block one chunk (one stage), the
    small levels split across blocks, shared memory as the source says."""
    got = {C: plan(112, hw, hw, C) for hw, C in ((48, 24), (24, 48),
                                                  (12, 96))}
    assert [(p["ncg"], p["chunks"], p["splits"]) for p in got.values()] == [
        (6, 1, 1), (6, 2, 2), (8, 3, 3)]
    assert [p["blocks"] * p["splits"] for p in got.values()] == [
        2688, 1344, 672]
    assert [p["smem"] for p in got.values()] == [
        16 * 126 * 16 + 31104, 16 * 126 * 16 + 31104, 16 * 160 * 16 + 31104]


@pytest.mark.parametrize("ncg", range(1, MAX_CG + 1))
def test_operand_loads_fall_on_distinct_bank_quads(ncg):
    """8 consecutive threads (a quarter warp's 16-byte loads) read float4s
    whose indices are distinct mod 8, at every tap and row."""
    rs = row_stride(ncg)
    assert rs % 8 == ncg % 8 and rs >= HX * ncg
    t = np.arange(PG * ncg)
    cg, pg = t % ncg, t // ncg
    r, gx = pg % TY, pg // TY * K
    for iy in range(D):
        for j in range(K + 2 * R):
            idx = (r + iy) * rs + (gx + j) * ncg + cg
            for q in range(0, t.size - 7, 8):
                assert len(set(idx[q:q + 8] % 8)) == 8
