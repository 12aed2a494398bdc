"""The dead-leaves composite (``ops/dead_leaves.py``) and the leaf table of
the render (``data/procedural.py:dead_leaves_table``) on the CPU.

* The table, computed for every leaf at once, holds the bits that the
  render's former loop computed leaf by leaf (``_loop_leaf_values``).
* ``dead_leaves_composite`` on CPU tensors is the plain version and leaves
  the kernel's counter alone; it raises on bad ranks, shapes and dtypes,
  and a tensor off the CPU launches or raises.
* The render and a pool ``refresh`` on the CPU give the bits of the former
  loop (``_render_as_before``).
* A numpy float32 model of ``kernels/csrc/dead_leaves.cu`` (the table staged
  in padded slices, each pixel's leaves in painter's order, one rounding an
  operation in the kernel's order), its sizes read out of the source,
  equals the plain version bit for bit.
* With a card only: the kernel equals the plain version bit for bit.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from dbsr_tpu_torch.data import procedural
from dbsr_tpu_torch.ops import dead_leaves
from dbsr_tpu_torch.ops.dead_leaves import (GRAD_AMP, LEAF_PARAMS,
                                            dead_leaves_composite,
                                            dead_leaves_composite_plain)

SOURCE = (Path(dead_leaves.__file__).resolve().parents[1] / "kernels"
          / "csrc" / "dead_leaves.cu").read_text()


def _bits(t):
    return t.contiguous().view(torch.int32)


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _draws(seed, n, num_leaves, device="cpu"):
    return procedural.dead_leaves_draws(
        procedural.make_generator(device, seed), n, num_leaves=num_leaves)


def _loop_leaf_values(draws, hw):
    """Each leaf's parameters as the render's former loop computed them,
    leaf by leaf: ``[n, L, 11]`` in ``LEAF_PARAMS`` order."""
    H, W = hw
    palette = draws["palette"]
    n, palette_size = palette.shape[:2]
    rmax = procedural.RMAX_FRAC * min(H, W)
    ratio2 = (procedural.RMIN / rmax) ** 2
    rows = torch.arange(n)
    leaves = []
    for i in range(draws["leaf_u"].shape[1]):
        u = draws["leaf_u"][:, i]
        r = procedural.RMIN * torch.rsqrt(1.0 - u[:, 0] * (1.0 - ratio2))
        cx = u[:, 1] * (W - 1)
        cy = u[:, 2] * (H - 1)
        theta = u[:, 3] * (2.0 * math.pi)
        a = torch.exp((u[:, 4] - 0.5) * 0.81)
        pj = (u[:, 5] * palette_size).to(torch.int64)
        color = (palette[rows, pj] + procedural.COLOR_JITTER
                 * draws["leaf_color_normal"][:, i]).clamp(0.0, 1.0)
        gx, gy = draws["leaf_grad"][:, i, 0], draws["leaf_grad"][:, i, 1]
        leaves.append(torch.stack(
            [r, cx, cy, torch.cos(theta), torch.sin(theta), a,
             color[:, 0], color[:, 1], color[:, 2], gx, gy], dim=-1))
    return torch.stack(leaves, dim=1)


def _render_as_before(draws, hw):
    """``dead_leaves_from_draws`` as it was: the leaf loop inline."""
    H, W = hw
    palette = draws["palette"]
    n = palette.shape[0]
    bg = (palette[:, 0] + procedural.COLOR_JITTER
          * draws["bg_normal"]).clamp(0.0, 1.0)
    img = bg[:, None, None, :].expand(n, H, W, 3)
    ys = torch.arange(H, dtype=torch.float32)[:, None]
    xs = torch.arange(W, dtype=torch.float32)[None, :]

    def col(v):
        return v[:, None, None]

    leaves = _loop_leaf_values(draws, hw)
    for i in range(leaves.shape[1]):
        r, cx, cy, ct, st, a, _, _, _, gx, gy = leaves[:, i].unbind(-1)
        color = leaves[:, i, 6:9].contiguous()
        ct, st = col(ct), col(st)
        dx = xs - col(cx)
        dy = ys - col(cy)
        xr = (ct * dx + st * dy) * col(a)
        yr = (-st * dx + ct * dy) / col(a)
        d = torch.sqrt(xr * xr + yr * yr + 1e-8)
        cover = (0.5 + (col(r) - d)).clamp(0.0, 1.0)
        shade = 1.0 + GRAD_AMP * (col(gx) * xr + col(gy) * yr) / col(r)
        c = color[:, None, None, :] * shade[..., None]
        img = img * (1.0 - cover[..., None]) + c * cover[..., None]
    img = img + procedural.TEXTURE_AMP * (
        procedural.octave_noise(draws["octaves"], hw) - 0.5)
    gdir = draws["illum_dir"]
    gdir = gdir / torch.sqrt((gdir * gdir).sum(dim=-1, keepdim=True) + 1e-8)
    amp = procedural.ILLUM_AMP * draws["illum_u"]
    ramp = (col(gdir[:, 0]) * (xs / W - 0.5)
            + col(gdir[:, 1]) * (ys / H - 0.5))
    img = img * (1.0 + col(amp)[..., None] * ramp[..., None])
    img = procedural.gaussian_blur(img, draws["sigma"])
    return img.clamp(0.0, 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11])
@pytest.mark.parametrize("n,L,hw", [(1, 1, (24, 40)), (3, 5, (17, 13)),
                                    (4, 300, (432, 432)), (2, 37, (8, 96))])
def test_leaf_table_has_the_loops_bits(seed, n, L, hw):
    draws = _draws(seed, n, L)
    bg, table = procedural.dead_leaves_table(draws, hw)
    assert table.shape == (n, L, len(LEAF_PARAMS))
    assert table.dtype == torch.float32 and table.is_contiguous()
    assert _same_bits(table, _loop_leaf_values(draws, hw))
    want_bg = (draws["palette"][:, 0] + procedural.COLOR_JITTER
               * draws["bg_normal"]).clamp(0.0, 1.0)
    assert _same_bits(bg, want_bg)


@pytest.mark.parametrize("L", [0, 1, 5, 40])
def test_composite_on_cpu_is_the_plain_loop_and_launches_nothing(L):
    hw = (13, 21)
    bg, table = procedural.dead_leaves_table(_draws(3, 2, L), hw)
    before = dead_leaves_composite.launches
    got = dead_leaves_composite(bg, table, hw)
    assert dead_leaves_composite.launches == before
    assert got.shape == (2,) + hw + (3,) and got.dtype == torch.float32
    assert _same_bits(got, dead_leaves_composite_plain(bg, table, hw))
    if L == 0:
        assert torch.equal(got, bg[:, None, None, :].expand_as(got))


def _bad(n=2, L=3):
    return torch.zeros(n, 3), torch.zeros(n, L, len(LEAF_PARAMS))


@pytest.mark.parametrize("case,error,match", [
    (lambda: (torch.zeros(2, 3, 1), _bad()[1]), ValueError, r"\[n,3\]"),
    (lambda: (torch.zeros(2, 4), _bad()[1]), ValueError, r"\[n,3\]"),
    (lambda: (_bad()[0], torch.zeros(2, 3 * len(LEAF_PARAMS))), ValueError,
     r"\[n,L,11\]"),
    (lambda: (_bad()[0], torch.zeros(3, 3, len(LEAF_PARAMS))), ValueError,
     r"\[n,L,11\]"),
    (lambda: (_bad()[0], torch.zeros(2, 3, 10)), ValueError, r"\[n,L,11\]"),
    (lambda: (_bad()[0].double(), _bad()[1]), TypeError, "float32"),
    (lambda: (_bad()[0], _bad()[1].to(torch.bfloat16)), TypeError,
     "float32"),
])
def test_wrapper_raises_on_what_it_does_not_take(case, error, match):
    bg, table = case()
    with pytest.raises(error, match=match):
        dead_leaves_composite(bg, table, (8, 8))


def test_wrapper_raises_off_the_cpu_without_falling_back():
    bg, table = _bad()
    before = dead_leaves_composite.launches
    with pytest.raises(ValueError, match="CUDA or CPU"):
        dead_leaves_composite(bg.to("meta"), table.to("meta"), (8, 8))
    assert dead_leaves_composite.launches == before


@pytest.mark.parametrize("seed,n,L,hw", [(0, 1, 5, (32, 32)),
                                         (7, 3, 300, (24, 40)),
                                         (2**31 + 5, 2, 60, (37, 19))])
def test_render_has_the_bits_of_the_former_loop(seed, n, L, hw):
    draws = _draws(seed, n, L)
    assert _same_bits(procedural.dead_leaves_from_draws(draws, hw),
                      _render_as_before(draws, hw))


@pytest.mark.parametrize("chunk", [2, 3])
def test_pool_refresh_on_cpu_has_the_bits_of_the_former_loop(chunk):
    pool = procedural.ProceduralImagePool(5, (40, 36), seed=9, chunk=chunk,
                                          device="cpu", num_leaves=30)
    got = pool.refresh(1)
    want = torch.cat([_render_as_before(procedural.dead_leaves_draws(
        procedural.make_generator("cpu", 9, 1, i), 1, num_leaves=30),
        (40, 36)) for i in range(5)])
    assert torch.equal(got, (want * 255.0 + 0.5).to(torch.uint8))


def _source_int(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_kernel_source_agrees_with_the_module():
    assert _source_int("kParams") == len(LEAF_PARAMS)
    assert float(re.search(r"constexpr float kGradAmp = ([0-9.]+)f;",
                           SOURCE).group(1)) == GRAD_AMP
    assert "dbsr_dead_leaves_composite_f32" in SOURCE
    assert "dead_leaves_composite_kernel" in SOURCE


def _kernel_model(bg, table, hw):
    """numpy float32 model of the kernel: per slice of ``kSlice`` leaves,
    the table's floats copied to a padded shared layout by the kernel's
    index arithmetic, then each leaf composited at every pixel, one
    rounding an operation, in the kernel's order (numpy's float32
    arithmetic is IEEE, as the _rn intrinsics). The square root is
    PyTorch's on the CPU, which the plain version takes there: it is not
    always the correctly rounded one (MKL's), where the kernel's
    ``__fsqrt_rn`` is."""
    f = np.float32
    H, W = hw
    n, L, params = table.shape
    slice_, padded = _source_int("kSlice"), _source_int("kPadded")
    tile_x, tile_y = _source_int("kTileX"), _source_int("kTileY")
    Hp, Wp = -(-H // tile_y) * tile_y, -(-W // tile_x) * tile_x
    yf = np.arange(Hp, dtype=f)[:, None]
    xf = np.arange(Wp, dtype=f)[None, :]
    out = np.empty((n, H, W, 3), f)
    for i in range(n):
        img = [np.full((Hp, Wp), v, f) for v in bg[i].numpy()]
        flat = table[i].numpy().reshape(-1)
        for base in range(0, L, slice_):
            count = min(slice_, L - base)
            shared = np.full(slice_ * padded, np.nan, f)
            for e in range(count * params):
                j = e // params
                shared[j * padded + (e - j * params)] = flat[base * params + e]
            for j in range(count):
                r, cx, cy, ct, st, a, c0, c1, c2, gx, gy = \
                    shared[j * padded:j * padded + params]
                dx = xf - cx
                dy = yf - cy
                xr = (ct * dx + st * dy) * a
                yr = ((-st) * dx + ct * dy) / a
                d = torch.sqrt(torch.from_numpy(
                    (xr * xr + yr * yr) + f(1e-8))).numpy()
                cover = np.minimum(np.maximum(f(0.5) + (r - d), f(0)), f(1))
                shade = f(1) + (f(GRAD_AMP) * (gx * xr + gy * yr)) / r
                keep = f(1) - cover
                img = [v * keep + (c * shade) * cover
                       for v, c in zip(img, (c0, c1, c2))]
        out[i] = np.stack(img, axis=-1)[:H, :W]
    return torch.from_numpy(out)


@pytest.mark.parametrize("L,hw", [(1, (13, 21)), (5, (17, 33)),
                                  (300, (19, 18))])
def test_kernel_model_equals_the_plain_version(L, hw):
    bg, table = procedural.dead_leaves_table(_draws(L, 2, L), hw)
    assert _same_bits(_kernel_model(bg, table, hw),
                      dead_leaves_composite_plain(bg, table, hw))


@pytest.mark.parametrize("L,hw", [(1, (13, 21)), (5, (17, 33)),
                                  (300, (37, 50))])
def test_kernel_equals_the_plain_version_on_a_card(L, hw):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version")
    bg, table = procedural.dead_leaves_table(_draws(L, 3, L, "cuda"), hw)
    before = dead_leaves_composite.launches
    got = dead_leaves_composite(bg, table, hw)
    again = dead_leaves_composite(bg, table, hw)
    assert dead_leaves_composite.launches == before + 2
    want = dead_leaves_composite_plain(bg, table, hw)
    assert _same_bits(got, want) and _same_bits(again, got)
