"""The port's resident training (``train.resident``, ``train_model(
resident=True)``, ``cli.train --resident_data``) and device augmentation
(``ops.augment_device``) on the CPU, against the port's own per-step path
and against the JAX package.

Random streams (the epoch permutation, augmentation, dropout) cannot
equal JAX's, so:

- the resident path is held against the port's per-step path on the same
  batch sequence and the same generator stream: losses rtol 1e-6,
  parameters rtol 1e-4 / atol 1e-5 (the tolerances of
  tests/test_resident.py; read: equal, as the two run the same eager ops);
- the resident slice is held against the JAX resident trainer where no
  stream enters: one batch of the whole set per epoch (its order does not
  change a step beyond round-off) and no augmentation. Losses rtol 1e-4
  and best parameters within 2 * lr, at most 1 % of the elements beyond
  1e-5 (the rule of tests/test_torch_port_train.py's train_model case);
- device augmentation is held to its distributions, beside JAX's own
  function: every rate within 5 binomial sigma, every draw within its
  bounds;
- preemption and resume on the CPU equal an uninterrupted run bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_enhancement_deglaring_tpu.eval import load_model_for_eval as jax_load_model_for_eval
from image_enhancement_deglaring_tpu.models import LightweightUNet as JaxUNet
from image_enhancement_deglaring_tpu.ops.augment_device import (
    device_augment_batch as jax_device_augment,
)
from image_enhancement_deglaring_tpu.train.loop import train_model as jax_train_model
from image_enhancement_deglaring_tpu_torch.cli import train as port_cli
from image_enhancement_deglaring_tpu_torch.data import generate_synthetic_sd1
from image_enhancement_deglaring_tpu_torch.eval import load_model_for_eval
from image_enhancement_deglaring_tpu_torch.modelio import export_jax_batch_stats, export_jax_params
from image_enhancement_deglaring_tpu_torch.models import EnhancedUNet, LightweightUNet
from image_enhancement_deglaring_tpu_torch.ops.augment_device import device_augment_batch
from image_enhancement_deglaring_tpu_torch.parallel import batch_sharding, make_mesh
from image_enhancement_deglaring_tpu_torch.train import (
    TrainState,
    make_optimizer,
    make_train_step,
    make_val_step,
    train_model,
)
from image_enhancement_deglaring_tpu_torch.train import resident
from image_enhancement_deglaring_tpu_torch.train.checkpoint import restore_checkpoint
from image_enhancement_deglaring_tpu_torch.train.resident import (
    ResidentData,
    batch_val_cache,
    cache_on_device,
    epoch_batch_plan,
    fits_on_device,
    make_train_epoch,
    make_val_epoch,
)
from image_enhancement_deglaring_tpu_torch.utils import flatten_tree
from tests.loaders import ArrayLoader
from tests.test_torch_port_train import _GuardAfter

SIZE = 32
ENH = 64  # EnhancedUNet's 5 levels
CPU = 1 << 30  # the CPU runs take their device budget as an argument


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Several test processes run at once: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def toy_data():
    rng = np.random.default_rng(7)
    y = rng.random((16, SIZE, SIZE, 1)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.15, y.shape), 0, 1).astype(np.float32)
    return x, y


def _up(a):
    """The 32^2 set at 64^2, for EnhancedUNet."""
    return np.repeat(np.repeat(a, 2, axis=1), 2, axis=2)


def _model(width=4):
    return LightweightUNet(features_start=width, generator=torch.Generator().manual_seed(0))


def _enhanced():
    return EnhancedUNet(init_features=4, generator=torch.Generator().manual_seed(0))


def _state(model, seed=0, lr=1e-3):
    return TrainState(model=model, optimizer=make_optimizer(model, lr, 1e-5),
                      generator=torch.Generator().manual_seed(seed))


def _cache(x, y, b, **kw):
    return cache_on_device(ArrayLoader(x, y, b), device="cpu", device_bytes=CPU, **kw)


def _params(model):
    return flatten_tree(export_jax_params(model))


def _assert_trees_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ----------------------------------------------------- epoch vs per-step


@pytest.mark.parametrize("kind", ["plain", "augment", "stateful_augment"])
def test_resident_epoch_matches_stepwise(toy_data, kind):
    """shuffle=False resident epoch == the per-step path over the same
    sequential batches and the same generator stream; with device
    augmentation, and with EnhancedUNet's BatchNorm and dropout."""
    x, y = toy_data
    stateful = kind == "stateful_augment"
    if stateful:
        x, y = _up(x[:8]), _up(y[:8])
    b = 4 if stateful else 8
    augment_fn = None if kind == "plain" else device_augment_batch
    make = _enhanced if stateful else _model

    ref = _state(make())
    step = make_train_step(stateful=stateful, augment_fn=augment_fn)
    ref_losses = []
    for i in range(len(x) // b):
        ref, loss = step(ref, torch.from_numpy(x[i * b:(i + 1) * b]),
                         torch.from_numpy(y[i * b:(i + 1) * b]))
        ref_losses.append(float(loss))

    data = _cache(x, y, b)
    epoch = make_train_epoch(batch_size=b, stateful=stateful, augment_fn=augment_fn,
                             shuffle=False)
    res, losses = epoch(_state(make()), data.x, data.y, 0, 0, data.n)
    np.testing.assert_allclose(losses.numpy(), np.asarray(ref_losses, np.float32), rtol=1e-6)
    for k, v in _params(ref.model).items():
        np.testing.assert_allclose(_params(res.model)[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    assert torch.equal(ref.generator.get_state(), res.generator.get_state())
    assert res.step == ref.step == len(x) // b
    if stateful:
        _assert_trees_equal(flatten_tree(export_jax_batch_stats(res.model)),
                            flatten_tree(export_jax_batch_stats(ref.model)))


def test_resident_shuffled_epoch_covers_each_sample_once():
    """Constant images whose loss names them, lr 0: two plans give other
    orders and the same epoch mean."""
    n, b = 16, 4
    levels = (np.arange(n, dtype=np.float32) / n)[:, None, None, None]
    x = np.broadcast_to(levels, (n, SIZE, SIZE, 1)).copy()
    y = np.zeros_like(x)
    data = _cache(x, y, b)
    epoch = make_train_epoch(batch_size=b, shuffle=True)
    _, l1 = epoch(_state(_model(), lr=0.0), data.x, data.y, 0, 1, data.n)
    _, l2 = epoch(_state(_model(), lr=0.0), data.x, data.y, 0, 2, data.n)
    assert not torch.equal(l1, l2)
    assert float(l1.mean()) == pytest.approx(float(l2.mean()), rel=1e-5)


def test_epoch_batch_plan_clamps_covers_and_is_a_function_of_seed_and_epoch():
    idx = epoch_batch_plan(0, 0, 6, 8, device="cpu")
    assert tuple(idx.shape) == (1, 6)  # batch > set: one short step
    idx = epoch_batch_plan(0, 3, 10, 4, device="cpu")
    assert tuple(idx.shape) == (2, 4) and len(set(idx.flatten().tolist())) == 8
    assert sorted(epoch_batch_plan(0, 3, 8, 4, device="cpu").flatten().tolist()) == list(range(8))
    assert torch.equal(epoch_batch_plan(5, 1, 64, 8, device="cpu"),
                       epoch_batch_plan(5, 1, 64, 8, device="cpu"))
    assert not torch.equal(epoch_batch_plan(5, 1, 64, 8, device="cpu"),
                           epoch_batch_plan(5, 2, 64, 8, device="cpu"))
    assert not torch.equal(epoch_batch_plan(5, 1, 64, 8, device="cpu"),
                           epoch_batch_plan(6, 1, 64, 8, device="cpu"))
    assert epoch_batch_plan(5, 1, 8, 4, shuffle=False, device="cpu").tolist() == \
        [[0, 1, 2, 3], [4, 5, 6, 7]]


# --------------------------------------------------------------- caching


def test_cache_casts_inputs_only(toy_data):
    x, y = toy_data
    data = _cache(x, y, 4, dtype=torch.bfloat16)
    assert data.x.dtype == torch.bfloat16 and data.y.dtype == torch.float32
    assert data.n == 16 and torch.equal(data.y, torch.from_numpy(y))
    assert torch.equal(data.x, torch.from_numpy(x).to(torch.bfloat16))


def test_cache_refusals(toy_data):
    x, y = toy_data

    class AugDs:
        augment = "optimized"

        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.zeros((SIZE, SIZE, 1)), np.zeros((SIZE, SIZE, 1))

    with pytest.raises(ValueError, match="augment"):
        cache_on_device(AugDs(), device="cpu", device_bytes=CPU)
    need = x.nbytes + y.nbytes
    with pytest.raises(ValueError, match="more than half"):
        cache_on_device(ArrayLoader(x, y, 4), device="cpu", device_bytes=2 * need - 1)
    cache_on_device(ArrayLoader(x, y, 4), device="cpu", device_bytes=2 * need)
    with pytest.raises(ValueError, match="device_bytes"):
        cache_on_device(ArrayLoader(x, y, 4), device="cpu")
    # each rank caches the whole set (train_model(mesh=)): JAX's sharded
    # cache has no counterpart and its argument is refused
    with pytest.raises(ValueError, match="sharding"):
        cache_on_device(ArrayLoader(x, y, 4), device="cpu", device_bytes=CPU,
                        sharding=batch_sharding(make_mesh(device="cpu")))
    with pytest.raises(ValueError, match="empty"):
        cache_on_device(ArrayLoader(x[:0], y[:0], 4), device="cpu", device_bytes=CPU)


def test_fits_on_device_sd1_scale():
    h100 = 80 * 10**9
    assert fits_on_device(1536, 512, dtype=torch.bfloat16, device_bytes=h100)
    assert not fits_on_device(200_000, 512, dtype=torch.float32, device_bytes=h100)
    # SD1 as cached (bf16 inputs, f32 targets): 2.25 GiB
    assert 1536 * 512 * 512 * (2 + 4) / 2**30 == pytest.approx(2.25)


# ------------------------------------------------------------ validation


def test_batch_val_cache_and_val_epoch_match_stepwise(toy_data):
    x, y = toy_data
    data = ResidentData(torch.from_numpy(x[:10]), torch.from_numpy(y[:10]), 10)
    xb, yb, masks = batch_val_cache(data, 4)
    assert tuple(xb.shape) == (3, 4, SIZE, SIZE, 1) and yb.shape == xb.shape
    assert masks.sum() == 10 and masks[2].tolist() == [1.0, 1.0, 0.0, 0.0]
    assert float(xb[2, 2:].abs().sum()) == 0.0
    model = _model()
    for with_metrics in (True, False):
        step = make_val_step(with_metrics=with_metrics)
        ref = [torch.stack([*step(model, xb[i], yb[i], masks[i])[:3], masks[i].sum()])
               for i in range(3)]
        got = make_val_epoch(with_metrics=with_metrics)(model, xb, yb, masks)
        np.testing.assert_allclose(got.numpy(), torch.stack(ref).numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ train_model


def _run(x, y, out, *, model=None, b=8, epochs=2, **kw):
    common = dict(epochs=epochs, lr=1e-3, output_dir=str(out), progress=False, device="cpu",
                  resident=True, device_augment=True, validation_metrics_every=100,
                  log_images_every=100, handle_preemption=False)
    common.update(kw)
    return train_model(model or _model(), ArrayLoader(x, y, b), ArrayLoader(x[:8], y[:8], 8),
                       **common)


def test_train_model_resident_deterministic_and_learns(tmp_path, toy_data):
    x, y = toy_data
    bp1, bms, bv1, s1 = _run(x, y, tmp_path / "a", epochs=3)
    bp2, _, bv2, _ = _run(x, y, tmp_path / "b", epochs=3)
    assert np.isfinite(bv1) and bv1 == bv2 and bms == {}
    assert s1.step == 3 * (len(x) // 8)
    _assert_trees_equal(flatten_tree(bp1), flatten_tree(bp2))


def test_resident_segment_count_does_not_change_training(tmp_path, toy_data):
    x, y = toy_data
    bp1, _, bv1, s1 = _run(x, y, tmp_path / "k1", b=2, resident_segments=1)
    bp4, _, bv4, s4 = _run(x, y, tmp_path / "k4", b=2, resident_segments=4)
    assert s1.step == s4.step == 2 * (len(x) // 2)
    assert bv1 == bv4
    _assert_trees_equal(flatten_tree(bp1), flatten_tree(bp4))
    assert torch.equal(s1.generator.get_state(), s4.generator.get_state())


def test_resident_stateful_enhanced_unet(tmp_path, toy_data):
    x, y = _up(toy_data[0][:8]), _up(toy_data[1][:8])
    _, bms, best_val, state = _run(x, y, tmp_path, model=_enhanced(), b=4, epochs=1)
    assert np.isfinite(best_val) and state.step == 2
    stats = flatten_tree(bms["batch_stats"])
    assert stats.keys() == flatten_tree(export_jax_batch_stats(_enhanced())).keys()
    assert any(not np.allclose(v, 0) for k, v in stats.items() if k.endswith("mean"))
    item, _ = restore_checkpoint(str(tmp_path / "best_model"))
    _assert_trees_equal(flatten_tree(item["model_state"]), flatten_tree(bms))


@pytest.mark.parametrize("stateful", [False, True])
def test_resident_preempt_and_resume_equal_uninterrupted(tmp_path, toy_data, stateful):
    """Preempted at a segment boundary of the first epoch, resumed from that
    checkpoint: parameters, BatchNorm statistics, generator state and step
    equal an uninterrupted run's bit for bit."""
    x, y = toy_data
    if stateful:
        x, y = _up(x[:8]), _up(y[:8])
    make = _enhanced if stateful else _model
    kw = dict(b=2, resident_segments=2, model=None)
    _, _, full_val, full = _run(x, y, tmp_path / "full", **{**kw, "model": make()})
    guard = _GuardAfter(0)  # the first read: between the first two segments
    _run(x, y, tmp_path / "cut", **{**kw, "model": make()}, preempt_guard=guard)
    meta = restore_checkpoint(guard.preempt_checkpoint)[1]
    assert meta["mid_epoch"] and meta["resident"] and meta["epoch"] == 0
    assert meta["epoch_step"] == (len(x) // 2) // 2
    _, _, val, resumed = _run(x, y, tmp_path / "cut", **{**kw, "model": make()},
                              resume_from=guard.preempt_checkpoint)
    assert resumed.step == full.step and val == full_val
    _assert_trees_equal(_params(resumed.model), _params(full.model))
    _assert_trees_equal(flatten_tree(export_jax_batch_stats(resumed.model)),
                        flatten_tree(export_jax_batch_stats(full.model)))
    assert torch.equal(resumed.generator.get_state(), full.generator.get_state())


def test_mid_epoch_resume_refuses_the_other_mode(tmp_path, toy_data):
    x, y = toy_data
    guard = _GuardAfter(0)
    _run(x, y, tmp_path / "res", b=2, resident_segments=2, preempt_guard=guard)
    with pytest.raises(ValueError, match="resident run but this resume is streaming"):
        _run(x, y, tmp_path / "res", b=2, resident=False, resume_from=guard.preempt_checkpoint)
    guard = _GuardAfter(0)  # the first read: after the first streaming step
    _run(x, y, tmp_path / "str", b=2, resident=False, preempt_guard=guard)
    assert restore_checkpoint(guard.preempt_checkpoint)[1]["resident"] is False
    with pytest.raises(ValueError, match="streaming run but this resume is resident"):
        _run(x, y, tmp_path / "str", b=2, resume_from=guard.preempt_checkpoint)


def test_resident_train_model_matches_jax(tmp_path, toy_data):
    """The slice against the JAX resident trainer where no random stream
    enters: 8 samples in one batch per epoch, no augmentation, 2 epochs."""
    x, y = toy_data[0][:8], toy_data[1][:8]
    init = export_jax_params(_model(width=8))
    common = dict(epochs=2, lr=2e-3, resident=True, progress=False, handle_preemption=False,
                  validation_metrics_every=1, init_params=init)
    jbest, _, jval, _ = jax_train_model(JaxUNet(), ArrayLoader(x, y, 8), ArrayLoader(x, y, 8),
                                        output_dir=str(tmp_path / "jax"), **common)
    tbest, _, tval, state = train_model(LightweightUNet(), ArrayLoader(x, y, 8),
                                        ArrayLoader(x, y, 8), output_dir=str(tmp_path / "port"),
                                        device="cpu", **common)
    assert state.step == 2
    assert tval == pytest.approx(jval, rel=1e-4)
    jb, tb = flatten_tree(jax.tree_util.tree_map(np.asarray, jbest)), flatten_tree(tbest)
    diffs = np.concatenate([np.abs(jb[k] - tb[k]).ravel() for k in jb])
    print(f"resident train_model vs JAX: best params max |diff| {diffs.max():.3g}, "
          f"{int((diffs > 1e-5).sum())} of {diffs.size} beyond 1e-5")
    assert diffs.max() <= 2 * 2e-3 and (diffs > 1e-5).sum() <= 1e-2 * diffs.size


# -------------------------------------------------------- augmentation


def augment_statistics(x0, xa, ya, y0):
    """Per-sample draws recovered from one augmented batch of distinct,
    asymmetric ramps in [0.35, 0.65] (no clipping at any draw): the flip
    from the target, then the image op from the un-flipped image: none,
    an exact affine map (brightness/contrast: alpha, beta) or additive
    noise (its variance)."""
    flips = np.array([not np.array_equal(a, b) for a, b in zip(ya, y0)])
    un = np.where(flips[:, None, None, None], xa[:, :, ::-1], xa)
    out = {"flip": flips, "pixel": [], "bc": [], "alpha": [], "beta": [], "var": []}
    for a, b in zip(x0.reshape(len(x0), -1), un.reshape(len(un), -1)):
        if np.array_equal(a, b):
            out["pixel"].append(False)
            continue
        out["pixel"].append(True)
        alpha, beta = np.polyfit(a.astype(np.float64), b.astype(np.float64), 1)
        affine = np.abs(alpha * a + beta - b).max() < 1e-5
        out["bc"].append(affine)
        if affine:
            out["alpha"].append(alpha)
            out["beta"].append(beta)
        else:
            out["var"].append(np.mean((b.astype(np.float64) - a) ** 2) * 255.0 ** 2)
    return {k: np.asarray(v) for k, v in out.items()}


def _check_rates(st, n):
    def within(hits, p, trials):
        return abs(hits.mean() - p) <= 5 * np.sqrt(p * (1 - p) / trials)

    assert within(st["flip"], 0.5, n) and within(st["pixel"], 0.5, n)
    assert within(st["bc"], 0.8, len(st["bc"]))
    assert st["alpha"].min() >= 0.8 - 1e-4 and st["alpha"].max() <= 1.2 + 1e-4
    assert st["beta"].min() >= -0.2 - 1e-4 and st["beta"].max() <= 0.2 + 1e-4
    assert st["alpha"].max() - st["alpha"].min() > 0.35  # the range is used
    # each variance read from 256 pixels: within its bounds up to the
    # estimate's own spread (~9 %), and the mean at U(10, 50)'s 30
    assert st["var"].min() >= 10 * 0.6 and st["var"].max() <= 50 * 1.4
    assert abs(st["var"].mean() - 30.0) <= 5 * (40 / np.sqrt(12)) / np.sqrt(len(st["var"])) + 1


def test_device_augmentation_distributions_beside_jax():
    n = 4096
    rng = np.random.default_rng(9)
    ramp = np.linspace(0.35, 0.65, 16 * 16, dtype=np.float32).reshape(16, 16)
    x0 = (ramp[None] + rng.uniform(-0.001, 0.001, (n, 1, 1)).astype(np.float32))[..., None]
    y0 = x0 * 0.5
    xa, ya = device_augment_batch(torch.Generator().manual_seed(0), torch.from_numpy(x0),
                                  torch.from_numpy(y0))
    assert xa.dtype == torch.float32 and ya.dtype == torch.float32
    st = augment_statistics(x0, xa.numpy(), ya.numpy(), y0)
    # the target flips with its image, and only flips
    np.testing.assert_array_equal(ya.numpy(), np.where(st["flip"][:, None, None, None],
                                                       y0[:, :, ::-1], y0))
    _check_rates(st, n)
    jx, jy = jax_device_augment(jax.random.PRNGKey(0), jnp.asarray(x0), jnp.asarray(y0))
    _check_rates(augment_statistics(x0, np.asarray(jx), np.asarray(jy), y0), n)
    xb, _ = device_augment_batch(torch.Generator().manual_seed(0),
                                 torch.from_numpy(x0[:8]).to(torch.bfloat16),
                                 torch.from_numpy(y0[:8]))
    assert xb.dtype == torch.bfloat16


# ------------------------------------------------------------------- CLI


def test_cli_train_enhanced_resident_device_augment(tmp_path, capsys):
    d = tmp_path / "sd1"
    generate_synthetic_sd1(str(d), n_train=6, n_val=0, size=ENH, seed=0)
    out = tmp_path / "run"
    port_cli.main(["--data_dir", str(d / "train"), "--output_dir", str(out), "--epochs", "1",
                   "--batch_size", "2", "--image_size", str(ENH), "--num_workers", "0",
                   "--model", "enhanced", "--resident_data", "--augment", "device",
                   "--validation_metrics_every", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "Epoch 1/1" in text and "Training completed" in text
    for name in ("best_model", "final_model", "model_weights.npz", "logs/metrics.jsonl"):
        assert os.path.exists(out / name), name
    with np.load(out / "model_weights.npz") as f:
        assert {k.split("/")[0] for k in f.files} == {"params", "batch_stats"}
    # final_model and model_weights.npz load into both packages as one model
    model, _ = load_model_for_eval(str(out / "final_model"), device="cpu")
    assert isinstance(model, EnhancedUNet)
    japply, jparams = jax_load_model_for_eval(str(out / "model_weights.npz"))
    xs = np.random.default_rng(1).random((1, ENH, ENH, 1)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(xs)).numpy()
    want = np.asarray(jax.jit(japply)({"params": jparams}, jnp.asarray(xs)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_cli_train_resident_flag_rules(tmp_path):
    with pytest.raises(SystemExit, match="heavy stack is host-only"):
        port_cli.main(["--data_dir", "unused", "--device", "cpu", "--resident_data",
                       "--augment", "heavy"])
    with pytest.raises(SystemExit, match="--remat is supported only for --model basic"):
        port_cli.main(["--data_dir", "unused", "--device", "cpu", "--model", "optimized",
                       "--remat"])
    with pytest.raises(ValueError, match="device_bytes"):
        resident.device_memory_bytes("cpu")
