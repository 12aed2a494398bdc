"""The port's kernel layer without a card: the numerics that the s2d conv's
tensor-core design rests on, and the host's launch path.

* 3xTF32: ``kernels/csrc/conv_s2d.cu`` splits each float32 operand into a
  TF32 ``big`` (``cvt.rna``: round to nearest, ties away from zero, to 10
  mantissa bits) and a TF32 ``small`` residual, and sums small*big,
  big*small, then big*big per 8-deep ``mma.sync`` step from zero, then adds
  the step to its running float32 sums, rounded. The tests emulate that
  with float32 bit operations on seeded numpy data at the decoder's K = 9 *
  32 = 288, against a float64 reference, with the tensor core's
  accumulation modelled as truncating (round toward zero) to float32 after
  each MMA: 3xTF32 stays within the limit ``chip_smoke.py`` holds the
  kernel to against its plain version (1e-5 of the largest output +
  1e-6), and plain 1xTF32 does not; the fresh sums of each step take the
  truncation's bias out (all MMAs into one running sum would be ~13x less
  accurate, and less accurate than float32 FMAs).
* ``kernels.launch`` with a stub library: each C entry is bound (its
  ``argtypes``) once over many calls; a non-zero return raises with the
  library's error string; an int outside int32 raises before the call;
  the entry runs with the tensors' device current (stand-ins for the
  current device, the device switch and a tensor on ``cuda:1``), the
  previous device is current again afterwards, also when the entry fails,
  and a launch on the current device switches nothing.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dbsr_tpu_torch import kernels

KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-6   # chip_smoke.py: kernel vs plain
K_DECODER = 9 * 32                      # 3x3 taps x 32 input channels
MMA_K = 8                               # depth of one mma.sync.m16n8k8


def tf32_rna(v):
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits' range to
    the magnitude, then clear them."""
    bits = np.asarray(v, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(v):
    v = np.asarray(v, dtype=np.float32)
    big = tf32_rna(v)
    return big, tf32_rna(v - big)


def to_f32_toward_zero(v):
    """float64 -> float32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def mma_chain(terms, m, n, fresh_steps=True):
    """Float32 sums of ``terms`` (pairs of [M, K] and [K, N] TF32 operands)
    as the kernel issues them: per 8-deep step, each term's products summed
    exactly and added to the float32 sums of the step, truncated; with
    ``fresh_steps`` (the kernel) those start from zero and are added to the
    running sums rounded to nearest, else every MMA adds into the running
    sums."""
    acc = np.zeros((m, n), np.float32)
    k = terms[0][0].shape[1]
    for k0 in range(0, k, MMA_K):
        step = np.zeros((m, n), np.float32) if fresh_steps else acc
        for a, b in terms:
            prods = a[:, k0:k0 + MMA_K].astype(np.float64) \
                @ b[k0:k0 + MMA_K].astype(np.float64)
            step = to_f32_toward_zero(step.astype(np.float64) + prods)
        acc = (acc + step) if fresh_steps else step
    return acc.astype(np.float64)


def ffma_chain(a, b):
    """The same sums by float32 FMAs, one k after another, rounded."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        acc = (acc.astype(np.float64)
               + a[:, k:k + 1].astype(np.float64) * b[k:k + 1]).astype(
                   np.float32)
    return acc.astype(np.float64)


def _operands(seed, m=2048, n=32):
    """A [M, 288] patch matrix of unit-variance activations and the
    [288, 32] weight of a 3x3 conv at He-like scale, float32."""
    rng = np.random.RandomState(seed)
    a = rng.randn(m, K_DECODER).astype(np.float32)
    w = (rng.randn(K_DECODER, n) / np.sqrt(K_DECODER)).astype(np.float32)
    return a, w


def _limit(ref):
    return KERNEL_RTOL * np.abs(ref).max() + KERNEL_ATOL


def test_tf32_rna_rounds_ties_away_from_zero():
    one = np.float32(1.0)
    half_ulp = np.float32(2.0 ** -11)   # TF32's ulp at 1 is 2^-10
    assert tf32_rna(one + half_ulp) == one + 2 * half_ulp
    assert tf32_rna(-(one + half_ulp)) == -(one + 2 * half_ulp)
    below = np.nextafter(one + half_ulp, one)
    assert tf32_rna(below) == one
    assert tf32_rna(np.float32(3.0)) == np.float32(3.0)
    # 10 mantissa bits kept: the low 13 of the float32 pattern are zero
    v = np.random.RandomState(0).randn(1000).astype(np.float32)
    assert not (tf32_rna(v).view(np.uint32) & np.uint32(0x1FFF)).any()


def test_split_keeps_float32_accuracy():
    v = np.random.RandomState(1).randn(10000).astype(np.float32) * 1e3
    big, small = split(v)
    rest = v.astype(np.float64) - big - small
    # what 3xTF32 drops: below 2^-22 of |v| (small is at most 2^-11 |v|,
    # rounded to 11 significant bits)
    assert (np.abs(rest) <= 2.0 ** -22 * np.abs(v)).all()
    assert (np.abs(small) <= 2.0 ** -11 * np.abs(v)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_within_kernel_limit_and_1xtf32_not(seed):
    a, w = _operands(seed)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    lim = _limit(ref)
    (ab, as_), (wb, ws) = split(a), split(w)
    three = mma_chain([(as_, wb), (ab, ws), (ab, wb)], *ref.shape)
    one = mma_chain([(ab, wb)], *ref.shape)
    err3 = np.abs(three - ref).max()
    err1 = np.abs(one - ref).max()
    assert err3 <= lim, (err3, lim)
    # 1xTF32 is a different result: ~1e-3 relative, far past the limit
    assert err1 > 10 * lim, (err1, lim)


@pytest.mark.parametrize("seed", [0, 1])
def test_fresh_step_sums_take_out_the_truncation_bias(seed):
    a, w = _operands(seed)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    (ab, as_), (wb, ws) = split(a), split(w)
    terms = [(as_, wb), (ab, ws), (ab, wb)]
    err_fresh = np.abs(mma_chain(terms, *ref.shape) - ref).max()
    err_running = np.abs(mma_chain(terms, *ref.shape, fresh_steps=False)
                         - ref).max()
    err_ffma = np.abs(ffma_chain(a, w) - ref).max()
    # all 108 truncating MMAs into one sum: ~1.4e-5, past FFMA's ~3e-6;
    # fresh sums per step: ~1e-6
    assert err_running > err_ffma, (err_running, err_ffma)
    assert err_fresh < err_ffma, (err_fresh, err_ffma)
    assert err_fresh * 8 < err_running, (err_fresh, err_running)


class _StubEntry:
    """A C entry: counts the assignments of its ``argtypes`` and its calls,
    returns ``rc``."""

    def __init__(self, rc):
        self.rc, self.calls, self.argtypes_sets = rc, [], 0
        self._argtypes = None
        self.restype = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.argtypes_sets += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _StubLibrary:
    def __init__(self, rc):
        self.dbsr_stub = _StubEntry(rc)

    @staticmethod
    def dbsr_error_string(err):
        return f"stub failure {err}".encode()


@pytest.fixture
def stub(monkeypatch):
    """``kernels.library`` returns a stub library (built with return code
    ``rc``), the bound entries start empty, and the current stream is a
    stand-in with handle 1234; returns the library and its lookups."""
    def make(rc=0):
        lib = _StubLibrary(rc)
        lookups = []

        def library(name):
            lookups.append(name)
            return lib
        monkeypatch.setattr(kernels, "library", library)
        monkeypatch.setattr(kernels, "_BOUND", {})
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device=None: SimpleNamespace(
                                cuda_stream=1234))
        return lib, lookups
    return make


def test_launch_binds_each_entry_once(stub):
    lib, lookups = stub()
    x, y = torch.zeros(4), torch.zeros(8)
    for _ in range(5):
        kernels.launch("stub", "dbsr_stub", (x, y), (3, 7))
    entry = lib.dbsr_stub
    assert entry.argtypes_sets == 1
    assert lookups == ["stub"]
    assert entry.argtypes == [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    assert entry.restype is ctypes.c_int
    assert entry.calls == [(x.data_ptr(), y.data_ptr(), 3, 7, 1234)] * 5


def test_launch_raises_with_the_error_string(stub):
    stub(rc=98)
    with pytest.raises(RuntimeError, match=r"dbsr_stub: CUDA error 98 "
                                           r"\(stub failure 98\)"):
        kernels.launch("stub", "dbsr_stub", (torch.zeros(4),), (1,))


@pytest.mark.parametrize("bad", [2 ** 31, -1])
def test_launch_rejects_ints_outside_int32(stub, bad):
    lib, _ = stub()
    with pytest.raises(ValueError, match="out of int32 range"):
        kernels.launch("stub", "dbsr_stub", (torch.zeros(4),), (5, bad))
    assert lib.dbsr_stub.calls == []


class _Devices:
    """Stand-ins for ``torch.cuda.current_device`` and
    ``torch.cuda.set_device``: the current index, and every switch."""

    def __init__(self, current=0):
        self.current, self.switches = current, []

    def current_device(self):
        return self.current

    def set_device(self, index):
        self.switches.append(index)
        self.current = index


def _on(index, ptr=4096):
    """A tensor stand-in whose device reports ``cuda:<index>``."""
    return SimpleNamespace(device=torch.device("cuda", index),
                           data_ptr=lambda: ptr)


@pytest.fixture
def devices(stub, monkeypatch):
    """The stub library of ``rc`` on stand-in devices with ``cuda:0``
    current; returns the devices and the device current at each call of
    the entry."""
    def make(rc=0):
        lib, _ = stub(rc)
        devs, seen = _Devices(0), []
        monkeypatch.setattr(torch.cuda, "current_device", devs.current_device)
        monkeypatch.setattr(torch.cuda, "set_device", devs.set_device)
        entry = lib.dbsr_stub

        class _Recording(_StubEntry):
            def __call__(self, *args):
                seen.append(devs.current)
                return entry(*args)
        lib.dbsr_stub = _Recording(rc)
        return devs, seen
    return make


def test_launch_runs_the_entry_on_the_tensors_device(devices):
    devs, seen = devices()
    x, y = _on(1, 4096), _on(1, 8192)
    kernels.launch("stub", "dbsr_stub", (x, y), (3,))
    assert seen == [1]                 # the entry ran with cuda:1 current
    assert devs.switches == [1, 0]     # in, then back out
    assert devs.current == 0


def test_launch_restores_the_device_when_the_entry_fails(devices):
    devs, seen = devices(rc=98)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        kernels.launch("stub", "dbsr_stub", (_on(1),), (1,))
    assert seen == [1]
    assert devs.switches == [1, 0]
    assert devs.current == 0


def test_launch_on_the_current_device_switches_nothing(devices):
    devs, seen = devices()
    for _ in range(3):
        kernels.launch("stub", "dbsr_stub", (_on(0),), (1,))
    assert seen == [0, 0, 0]
    assert devs.switches == []
