"""The port's host-fed image pipeline against the JAX package on CPU: the
transforms and ``CropBatcher`` (bit-equal batches for the same seed and
images), the samplers, the ``DevicePrefetcher`` (the JAX package's four
cases, ``device_put``, the trainer's batches in the inline order, ``close()``
on a rollback), ``warp_affine`` (rtol 1e-5 / atol 1e-6 against JAX's
gather, on affines with shear and scale) and ``smoke_tiny``.
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dbsr_tpu.configs.dbsr import smoke_tiny as jax_smoke_tiny
from dbsr_tpu.data import pipeline as jpipe
from dbsr_tpu.data import transforms as jtf
from dbsr_tpu.ops import interp as jinterp
from dbsr_tpu_torch.configs.dbsr import smoke_tiny
from dbsr_tpu_torch.data import pipeline, transforms
from dbsr_tpu_torch.data.procedural import make_generator
from dbsr_tpu_torch.data.synthetic import BurstConfig
from dbsr_tpu_torch.environment import Settings
from dbsr_tpu_torch.models.dbsr import dbsrnet_tiny
from dbsr_tpu_torch.ops import interp
from dbsr_tpu_torch.training import trainer as trainer_mod
from dbsr_tpu_torch.training.actors import make_synthetic_actor
from dbsr_tpu_torch.training.state import make_optimizer
from dbsr_tpu_torch.training.trainer import LoaderSpec, Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (the suite runs
    in parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Imgs:
    """Images of ``RandomState(i)``, uint8 or float32; every
    ``fail_every``-th read raises."""

    def __init__(self, n=3, hw=(60, 70), fail_every=None, dtype=np.uint8):
        self.n, self.hw, self.fail_every, self.dtype = n, hw, fail_every, dtype
        self.calls = 0

    def get_num_images(self):
        return self.n

    def get_image(self, i, info=None):
        self.calls += 1
        if self.fail_every and self.calls % self.fail_every == 0:
            raise IOError("flaky disk")
        im = np.random.RandomState(i).rand(*self.hw, 3)
        if self.dtype == np.uint8:
            return (im * 255).astype(np.uint8), {}
        return im.astype(np.float32), {}


# --- transforms --------------------------------------------------------------

STAGES = [
    ("ToFloat", lambda m: m.ToFloat()),
    ("ToFloatAndJitter", lambda m: m.ToFloatAndJitter(0.3)),
    ("ToFloatAndJitter_raw", lambda m: m.ToFloatAndJitter(0.2, False)),
    ("Normalize", lambda m: m.Normalize([0.4, 0.5, 0.6], [0.2, 0.25, 0.3])),
    ("ToGrayscale", lambda m: m.ToGrayscale(0.5)),
    ("ToBGR", lambda m: m.ToBGR()),
    ("RandomHorizontalFlip", lambda m: m.RandomHorizontalFlip(0.5)),
]


@pytest.mark.parametrize("name,make", STAGES, ids=[s[0] for s in STAGES])
def test_transform_stage_is_bit_equal_to_jax(name, make):
    a = np.random.RandomState(1).randint(0, 256, (6, 7, 3)).astype(np.uint8)
    b = np.random.RandomState(2).randint(0, 256, (6, 7, 3)).astype(np.uint8)
    if name in ("Normalize", "ToGrayscale", "ToBGR",
                "RandomHorizontalFlip"):
        a, b = a.astype(np.float32) / 255.0, b.astype(np.float32) / 255.0
    got_stage, want_stage = make(transforms).seed(5), make(jtf).seed(5)
    for _ in range(6):
        got, want = got_stage(a, b), want_stage(a, b)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_composed_transform_shares_each_roll_and_equals_jax():
    def compose(m):
        return m.Transform(m.ToFloatAndJitter(0.25), m.ToGrayscale(0.5),
                           m.RandomHorizontalFlip(0.5)).seed(11)

    got_t, want_t = compose(transforms), compose(jtf)
    im = np.random.RandomState(3).randint(0, 256, (5, 9, 3)).astype(np.uint8)
    for _ in range(8):
        g1, g2 = got_t(im, im.copy())
        w1, w2 = want_t(im, im.copy())
        np.testing.assert_array_equal(g1, g2)     # one roll per call
        np.testing.assert_array_equal(g1, w1)
        np.testing.assert_array_equal(g2, w2)
    single = got_t(im)
    assert isinstance(single, np.ndarray) and single.shape == im.shape


# --- samplers and CropBatcher ------------------------------------------------

def test_samplers_match_jax_and_retry():
    got = pipeline.RandomImageSampler([Imgs(fail_every=3), Imgs(n=5)],
                                      [1.0, 2.0], samples_per_epoch=10)
    want = jpipe.RandomImageSampler([Imgs(fail_every=3), Imgs(n=5)],
                                    [1.0, 2.0], samples_per_epoch=10)
    rg, rw = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(10):
        np.testing.assert_array_equal(got.sample(rg), want.sample(rw))
    assert len(got) == 10
    never = pipeline.RandomImageSampler([Imgs(fail_every=1)], [1.0], 1,
                                        max_retries=3)
    with pytest.raises(RuntimeError, match="after 3 retries"):
        never.sample(np.random.default_rng(0))
    idx = pipeline.IndexedImageSampler(Imgs(n=4))
    assert len(idx) == 4
    np.testing.assert_array_equal(idx.get(2), Imgs().get_image(2)[0])


BATCHERS = {
    "uint8": dict(),
    "float32": dict(transfer_dtype="float32"),
    "jitter": dict(brightness_jitter=0.3),
    "no_flip": dict(random_flip=False),
    "centre_crop": dict(random_crop=False),
    "scale_ar": dict(scale_range=(0.8, 1.3), ar_range=(0.8, 1.2)),
}


@pytest.mark.parametrize("kind", sorted(BATCHERS))
@pytest.mark.parametrize("image_dtype", [np.uint8, np.float32])
def test_crop_batcher_is_bit_equal_to_jax(kind, image_dtype):
    def make(m):
        sampler = m.RandomImageSampler([Imgs(n=4, dtype=image_dtype)], [1.0],
                                       samples_per_epoch=12)
        return m.CropBatcher(sampler, 3, (32, 40), seed=7, **BATCHERS[kind])

    got_b, want_b = make(pipeline), make(jpipe)
    assert len(got_b) == len(want_b) == 4
    for _ in range(3):
        got, want = got_b.next_batch(), want_b.next_batch()
        assert got.dtype == want.dtype and got.shape == (3, 32, 40, 3)
        np.testing.assert_array_equal(got, want)
    for pid in (0, 3):
        g2, w2 = make(pipeline), make(jpipe)
        g2.fold_in_process(pid)
        w2.fold_in_process(pid)
        np.testing.assert_array_equal(g2.next_batch(), w2.next_batch())


# --- DevicePrefetcher --------------------------------------------------------

def test_prefetcher_yields_all_batches():
    count = [0]

    def make():
        count[0] += 1
        return np.full((2, 4, 4, 3), count[0], np.float32)

    pf = pipeline.DevicePrefetcher(make, 5)
    got = list(pf)
    assert len(got) == 5
    assert [float(b[0, 0, 0, 0]) for b in got] == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert pf.wait_s >= 0.0 and pf.batch_s > 0.0


def test_prefetcher_propagates_errors():
    def bad():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="prefetch worker failed"):
        list(pipeline.DevicePrefetcher(bad, 3))


def test_prefetcher_close_releases_blocked_worker():
    """Abandoning iteration mid-epoch: ``close()`` drains the queue and
    stops the worker, so a retried epoch's prefetcher owns the batcher."""
    calls = [0]

    def make():
        calls[0] += 1
        return np.zeros((2, 4, 4, 3), np.float32)

    pf = pipeline.DevicePrefetcher(make, 100, depth=2)
    it = iter(pf)
    next(it)
    pf.close()
    assert not pf._thread.is_alive()
    produced = calls[0]
    time.sleep(0.2)
    assert calls[0] == produced
    assert produced < 100


def test_prefetcher_close_idempotent_after_completion():
    pf = pipeline.DevicePrefetcher(lambda: np.zeros((1,), np.float32), 3)
    assert len(list(pf)) == 3
    pf.close()
    pf.close()


def test_prefetcher_device_put_runs_on_the_worker_in_order():
    """``device_put`` runs on the one worker thread after each batch, in
    order; ``pinned_device_put`` makes tensors of numpy arrays (on the
    CPU, without pinning)."""
    seen, count = [], [0]

    def make():
        count[0] += 1
        return np.full((2, 3), count[0], np.uint8)

    put = pipeline.pinned_device_put("cpu")

    def device_put(b):
        seen.append(threading.current_thread().name)
        return put(b)

    got = list(pipeline.DevicePrefetcher(make, 4, device_put))
    assert [int(b[0, 0]) for b in got] == [1, 2, 3, 4]
    assert all(torch.is_tensor(b) and b.dtype == torch.uint8 for b in got)
    assert len(set(seen)) == 1 and seen[0] != \
        threading.current_thread().name
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)[:, ::-1]
    t = put(arr)
    assert torch.equal(t, torch.from_numpy(arr.copy()))


# --- the trainer through the prefetcher --------------------------------------

CFG = BurstConfig(burst_size=3, crop_sz=(32, 32), border_crop=4,
                  max_translation=3.0, fused_resample=True)


def _host_trainer(workspace, record):
    """A tiny trainer on host-made crops fed through the prefetcher;
    ``record`` gets each batch that reaches ``prepare_fn``."""
    from dbsr_tpu_torch.configs.dbsr.default_synthetic import \
        make_crop_prepare_fn

    prepare = make_crop_prepare_fn(CFG)

    def prepare_fn(generator, crops):
        record.append(crops.clone())
        return prepare(generator, crops)

    batcher = pipeline.CropBatcher(
        pipeline.RandomImageSampler([Imgs(n=4)], [1.0], samples_per_epoch=6),
        2, CFG.pre_crop_sz, seed=3)
    net = dbsrnet_tiny()
    return Trainer(net, make_synthetic_actor(net, boundary_ignore=4),
                   make_optimizer(base_lr=1e-3, steps_per_epoch=3),
                   [LoaderSpec("train", batcher)], prepare_fn,
                   str(workspace), net_name="tiny", print_interval=1, seed=4,
                   device="cpu", device_put=pipeline.pinned_device_put("cpu"))


def test_trainer_batches_are_the_inline_order(tmp_path):
    """Two epochs through the prefetcher: ``prepare_fn`` gets the batcher's
    batches in the order ``next_batch()`` makes them inline."""
    record = []
    t = _host_trainer(tmp_path, record)
    state = t.train(2)
    assert state.step == 6 and len(record) == 6
    inline = pipeline.CropBatcher(
        pipeline.RandomImageSampler([Imgs(n=4)], [1.0], samples_per_epoch=6),
        2, CFG.pre_crop_sz, seed=3)
    for got in record:
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), inline.next_batch())
    feed = t.feed["train"]
    assert feed["batches"] == 3 and feed["batch_s"] > 0.0


def test_trainer_closes_the_prefetcher_before_a_rollback(tmp_path,
                                                         monkeypatch, capsys):
    """A mid-epoch divergence in epoch 2: the cycle's prefetcher is closed
    (its worker stopped) before training rolls back and retries."""
    closed = []

    class Recording(pipeline.DevicePrefetcher):
        def close(self):
            super().close()
            closed.append((self._thread is not None
                           and self._thread.is_alive(), trainer.epoch))

    monkeypatch.setattr(trainer_mod, "DevicePrefetcher", Recording)
    trainer = _host_trainer(tmp_path, [])
    trainer.intra_divergence_factor = 5.0
    actor = trainer.actor_fn

    def blow_up(batch):
        loss, stats = actor(batch)
        if trainer.epoch == 2 and trainer._retry_salt == 0:
            loss = loss * 50.0
            stats = dict(stats, **{"Loss/total": stats["Loss/total"] * 50.0})
        return loss, stats

    trainer.actor_fn = blow_up
    state = trainer.train(2)
    out = capsys.readouterr().out
    assert "Mid-epoch divergence at epoch 2" in out
    assert "(epoch 1, step 3)" in out and state.step == 6
    # epoch 1, the aborted epoch 2 (closed at epoch 2, before the rollback
    # set it back to 1), the retried epoch 2; every worker stopped
    assert [e for _, e in closed] == [1, 2, 2]
    assert not any(alive for alive, _ in closed)


# --- warp_affine -------------------------------------------------------------

def _affines(rng, lead):
    th = rng.uniform(-0.3, 0.3, lead)
    shear = rng.uniform(-0.2, 0.2, lead)
    scale = rng.uniform(0.8, 1.25, lead)
    c, s = np.cos(th), np.sin(th)
    return np.stack([
        np.stack([scale * c, -s + shear, rng.uniform(-3, 3, lead)], -1),
        np.stack([s, 1.1 * scale * c, rng.uniform(-3, 3, lead)], -1)],
        -2).astype(np.float32)


@pytest.mark.parametrize("shape,out_hw", [
    ((24, 32, 3), None), ((2, 40, 36, 3), (20, 28)), ((3, 17, 23, 1),
                                                       (30, 19)),
    ((2, 16, 20, 6), None)])
def test_warp_affine_matches_jax(shape, out_hw):
    rng = np.random.RandomState(sum(shape))
    im = rng.rand(*shape).astype(np.float32)
    tmat = _affines(rng, shape[:-3])
    want = np.asarray(jinterp.warp_affine(jnp.asarray(im), jnp.asarray(tmat),
                                          out_hw))
    got = interp.warp_affine(torch.from_numpy(im), torch.from_numpy(tmat),
                             out_hw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_warp_affine_identity_and_shift():
    im = torch.from_numpy(np.random.RandomState(0).rand(2, 9, 11, 3)
                          .astype(np.float32))
    eye = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).expand(2, 2, 3)
    assert torch.equal(interp.warp_affine(im, eye), im)
    shift = torch.tensor([[1.0, 0.0, 2.0], [0.0, 1.0, 1.0]])
    out = interp.warp_affine(im, shift)
    assert torch.equal(out[:, 1:, 2:], im[:, :-1, :-2])
    assert not out[:, 0].any() and not out[:, :, :2].any()


# --- smoke_tiny --------------------------------------------------------------

def test_smoke_tiny_first_host_batch_is_bit_equal_to_jax(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(tmp_path / "ws"))
    t = smoke_tiny.make_trainer(Settings(), device="cpu")
    got = t.loaders[0].batcher.next_batch()
    want = jpipe.CropBatcher(
        jpipe.RandomImageSampler([jax_smoke_tiny.ProceduralImages()], [1.0],
                                 samples_per_epoch=8),
        2, (40, 40)).next_batch()
    assert got.dtype == np.uint8 and got.shape == (2, 40, 40, 3)
    np.testing.assert_array_equal(got, want)
    for a, b in zip(smoke_tiny.ProceduralImages().images,
                    jax_smoke_tiny.ProceduralImages().images):
        np.testing.assert_array_equal(a, b)
    batch = t.prepare_fn(make_generator("cpu", 1), torch.from_numpy(got))
    assert batch["burst"].shape == (2, 3, 8, 8, 4)


def test_smoke_tiny_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    from dbsr_tpu_torch.run_training import main

    monkeypatch.setenv("DBSR_TPU_ENV", str(tmp_path / "env.json"))
    monkeypatch.setenv("DBSR_TPU_WORKSPACE_DIR", str(tmp_path / "ws"))
    main(["dbsr", "smoke_tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Finished training!" in out and "[train: 2, 4/4]" in out
    ws = tmp_path / "ws" / "dbsr" / "smoke_tiny"
    assert (ws / "smoke_ep0001.ckpt").exists()
    assert (ws / "smoke_ep0002.ckpt").exists()
    losses = [float(v) for v in
              __import__("re").findall(r"Loss/total: ([\d.]+)", out)]
    assert losses and np.all(np.isfinite(losses))
