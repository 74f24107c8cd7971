"""Port vs reference: the training substrates on the CPU.

Gradient compression, the synthetic data pipeline, checkpoints, the
``Trainer`` and its launcher, against ``repro.optim.compress``,
``repro.data``, ``repro.checkpoint`` and ``repro.train`` on the same
inputs.  Held:

* ``compressed_grads``: int8 codes, scale, dequantised grads and residual
  equal the reference's (eager) bitwise, over steps that carry the
  residual;
* ``SyntheticPipeline``: tokens, labels and the bf16 frontend stubs equal
  the reference's batch for batch, after ``load_state_dict`` and on a
  process's slice;
* ``CheckpointManager``: round trip, keep-k, ``*.tmp`` ignored, and the
  ``params/...`` subtree read across packages both ways;
* ``Trainer``: the reference's own contracts (``tests/test_substrates.py``:
  loss decreases, microbatch equivalence at rel 2e-3, preemption recovery
  at rel 1e-4), and 3 steps of reduced qwen1.5-0.5b and hymba-1.5b from
  the reference's weights with the loss history within 2e-2 of the
  reference ``Trainer``'s: the slice as a whole.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS as J_ARCHS
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticPipeline as JSyntheticPipeline
from repro.models.api import build_model as j_build_model
from repro.models.common import ShapeCfg as JShapeCfg
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import compress as j_compress
from repro.train import TrainConfig as JTrainConfig, Trainer as JTrainer
from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.api import build_model
from repro_torch.models.common import ShapeCfg
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.parallel import ParallelCfg
from repro_torch.optim import AdamWConfig, compress
from repro_torch.train import TrainConfig, Trainer

PAR = ParallelCfg(remat="none")
JPAR = JParallelCfg(mesh=None, remat="none")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several workers per host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _jbits(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ---------------------------------------------------------------------------
# Compression.
# ---------------------------------------------------------------------------

def test_compressed_grads_bitwise():
    """Four steps of error feedback on float32 grads (one leaf of scale
    1 with exact halves, so round-half-to-even decides): the int8 codes and
    scale of ``_q8``, the dequantised grads and the residual equal the
    reference's bit for bit."""
    rng = np.random.default_rng(0)
    grads = [{"w": rng.standard_normal((64, 32)).astype(np.float32),
              "b": np.array([127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5,
                             -126.5], np.float32)} for _ in range(4)]
    jstate = j_compress.compress_init({k: jnp.asarray(v)
                                       for k, v in grads[0].items()})
    state = compress.compress_init({k: torch.from_numpy(v)
                                    for k, v in grads[0].items()})
    for g in grads:
        jdeq, jstate, jm = j_compress.compressed_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate)
        deq, state, m = compress.compressed_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, state)
        for k in g:
            assert (_bits(deq[k]) == _jbits(jdeq[k])).all(), k
            assert (_bits(state.residual[k])
                    == _jbits(jstate.residual[k])).all(), k
            x = g[k] + np.asarray(jstate.residual[k])
            jq, js = j_compress._q8(jnp.asarray(x))
            q, s = compress._q8(torch.from_numpy(x))
            assert q.dtype == torch.int8
            assert (q.numpy() == np.asarray(jq)).all()
            assert _bits(s) == _jbits(js)
        assert float(m["compress_residual_sq"]) == pytest.approx(
            float(jm["compress_residual_sq"]), rel=1e-6)


def test_compress_error_feedback_preserves_signal():
    """The reference's contract: the dequantised sum over 8 steps converges
    to 8 x g (``tests/test_substrates.py``)."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=1000).astype(np.float32))}
    state = compress.compress_init(g)
    total = torch.zeros(1000)
    for _ in range(8):
        deq, state, _ = compress.compressed_grads(g, state)
        total += deq["w"]
    assert float((total - 8 * g["w"]).abs().max()) < \
        0.05 * float(g["w"].abs().max())


# ---------------------------------------------------------------------------
# Data pipeline.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "whisper-base",
                                  "llava-next-34b"])
def test_pipeline_matches_reference(arch):
    """Three batches, then a pipeline restarted at step 2 and a second
    process's slice: every key, dtype and value equal to the reference's
    (bf16 stubs bit for bit)."""
    cfg, jcfg = configs.get(arch).reduced(), J_ARCHS[arch].reduced()
    shape = ShapeCfg("t", "train", 64, 4)
    jshape = JShapeCfg("t", "train", 64, 4)

    def same(b, jb):
        assert list(b) == list(jb)
        for k, v in jb.items():
            want = np.asarray(v.astype(jnp.float32) if v.dtype ==
                              jnp.bfloat16 else v)
            got = b[k].float() if b[k].dtype == torch.bfloat16 else b[k]
            assert str(b[k].dtype).split(".")[1] == str(v.dtype), k
            assert (got.numpy() == want).all(), k

    p, jp = (SyntheticPipeline(cfg, shape, device="cpu"),
             JSyntheticPipeline(jcfg, jshape))
    for _ in range(3):
        same(p.next_batch(), jp.next_batch())
    p2, jp2 = (SyntheticPipeline(cfg, shape, device="cpu"),
               JSyntheticPipeline(jcfg, jshape))
    p2.load_state_dict({"step": 2})
    jp2.load_state_dict({"step": 2})
    assert p2.state_dict() == {"step": 2}
    same(p2.next_batch(), jp2.next_batch())
    p3 = SyntheticPipeline(cfg, shape, DataConfig(seed=7), process_index=1,
                           process_count=2, device="cpu")
    jp3 = JSyntheticPipeline(jcfg, jshape, JDataConfig(seed=7),
                             process_index=1, process_count=2)
    b = p3.next_batch()
    same(b, jp3.next_batch())
    assert b["tokens"].shape[0] == 2


def test_pipeline_labels_are_next_tokens():
    cfg = configs.get("qwen1.5-0.5b").reduced()
    b = SyntheticPipeline(cfg, ShapeCfg("t", "train", 32, 4),
                          device="cpu").next_batch()
    t, lab = b["tokens"], b["labels"]
    assert t.dtype == lab.dtype == torch.int32
    assert bool((lab[:, :-1] == t[:, 1:]).all() and (lab[:, -1] == -1).all())


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------

def _tree():
    return {"a": torch.arange(5), "b": {"c": torch.ones((2, 2)),
                                        "d": torch.full((3,), 0.5,
                                                        dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip_keep_k(tmp_path):
    """Three saves with keep 2 leave the last two; a restore gives the
    saved values in the template's structure, dtypes and devices (bf16
    included); async saves are complete after ``wait``."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    mgr.save(1, tree, blocking=True)
    mgr.save(2, tree)
    mgr.save(3, {**tree, "step": torch.tensor(9, dtype=torch.int32)})
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    like = {"a": torch.zeros(5, dtype=torch.int64),
            "b": {"c": torch.zeros((2, 2)),
                  "d": torch.zeros(3, dtype=torch.bfloat16)},
            "step": torch.zeros((), dtype=torch.int32)}
    out = mgr.restore(like)
    assert torch.equal(out["a"], torch.arange(5))
    assert out["b"]["d"].dtype == torch.bfloat16
    assert torch.equal(out["b"]["d"], tree["b"]["d"])
    assert int(out["step"]) == 9
    assert int(mgr.restore(like, step=2)["step"]) == 7
    with pytest.raises(KeyError):
        mgr.restore({"missing": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"a": torch.zeros(4)})


def test_checkpoint_ignores_incomplete_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, {"x": torch.ones(3)}, blocking=True)
    os.makedirs(tmp_path / "step_00000009.tmp")      # simulated crash
    assert mgr.latest() == 5 and mgr.all_steps() == [5]
    assert CheckpointManager(str(tmp_path / "empty")).restore(
        {"x": torch.ones(3)}) is None


def test_checkpoint_params_cross_packages(tmp_path):
    """The reference's Trainer checkpoint's ``params`` subtree restores
    into the port's model tree, and the port's into the reference's, with
    equal values: one layout, ``step_N/proc_0.npz`` keyed by ``/`` paths."""
    cfg, jcfg = (configs.get("qwen1.5-0.5b").reduced(),
                 J_ARCHS["qwen1.5-0.5b"].reduced())
    jt = JTrainer(j_build_model(jcfg), jcfg, JPAR,
                  JTrainConfig(steps=1, log_every=1),
                  shape=JShapeCfg("t", "train", 16, 2),
                  ckpt_dir=str(tmp_path / "ref"))
    jt.init(seed=0)
    jt.ckpt.save(1, jt.state, blocking=True)
    model = build_model(cfg, "cpu", seed=3)
    got = CheckpointManager(str(tmp_path / "ref")).restore(
        {"params": model.tree()})
    want = jax.tree.map(np.asarray, jt.state["params"])

    def compare(t, w):
        for k, v in w.items():
            if isinstance(v, dict):
                compare(t[k], v)
            else:
                assert (t[k].numpy() == v).all()
    compare(got["params"], want)

    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(4, {"params": model.tree(), "data": {"step": torch.tensor(4)}},
             blocking=True)
    back = JCheckpointManager(str(tmp_path / "port")).restore(
        {"params": jax.tree.map(jnp.zeros_like, jt.state["params"])})
    compare({"params": {k: v for k, v in model.tree().items()}},
            {"params": jax.tree.map(np.asarray, back["params"])})


# ---------------------------------------------------------------------------
# Trainer.
# ---------------------------------------------------------------------------

def _mini_trainer(tmp, steps=6, micro=1, fault_hook=None):
    cfg = configs.get("qwen1.5-0.5b").reduced()
    tc = TrainConfig(steps=steps, microbatches=micro, ckpt_every=2,
                     log_every=1,
                     opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=steps))
    return Trainer(build_model(cfg, "cpu", seed=0, par=PAR), tc,
                   shape=ShapeCfg("t", "train", 64, 4), ckpt_dir=tmp,
                   fault_hook=fault_hook)


def test_trainer_loss_decreases(tmp_path):
    tr = _mini_trainer(str(tmp_path), steps=10)
    tr.resume()
    hist = tr.run()
    assert [m["step"] for m in hist] == list(range(1, 11))
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert set(hist[0]) == {"loss", "grad_norm", "lr", "step", "sec"}
    assert CheckpointManager(str(tmp_path)).all_steps() == [6, 8, 10]


def test_microbatch_equivalence():
    """Two microbatches give the one-batch losses at rel 2e-3 (the
    reference's bound; bf16 activations)."""
    h = []
    for micro in (1, 2):
        tr = _mini_trainer(None, steps=3, micro=micro)
        tr.init(seed=0)
        h.append(tr.run())
    assert h[0][-1]["loss"] == pytest.approx(h[1][-1]["loss"], rel=2e-3)


def test_preemption_recovery(tmp_path):
    """Crash at step 4; a fresh Trainer resumes from the latest complete
    checkpoint (step 4, or step 2 if the async step-4 save had not
    finished) and its final loss matches an uninterrupted run at rel
    1e-4."""
    class Crash(Exception):
        pass

    def bomb(step):
        if step == 4:
            raise Crash()

    tr = _mini_trainer(str(tmp_path), steps=6, fault_hook=bomb)
    tr.resume()
    with pytest.raises(Crash):
        tr.run()
    tr2 = _mini_trainer(str(tmp_path), steps=6)
    start = tr2.resume()
    assert start in (2, 4) and tr2.pipeline.step == start
    hist = tr2.run()
    tr3 = _mini_trainer(None, steps=6)
    tr3.init(seed=0)
    ref = tr3.run()
    assert hist[-1]["loss"] == pytest.approx(ref[-1]["loss"], rel=1e-4)


def test_compressed_training_resumes(tmp_path):
    """With compression on, the residual is part of the state: history
    entries carry ``compress_residual_sq`` and a resumed run restores the
    residual, ending on the uninterrupted run's loss bitwise."""
    def trainer(tmp, steps):
        cfg = configs.get("qwen1.5-0.5b").reduced()
        tc = TrainConfig(steps=steps, ckpt_every=2, log_every=1,
                         compress_grads=True,
                         opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                         total_steps=4))
        return Trainer(build_model(cfg, "cpu", seed=0, par=PAR), tc,
                       shape=ShapeCfg("t", "train", 32, 2), ckpt_dir=tmp)
    first = trainer(str(tmp_path), 2)
    first.resume()
    first.run()
    second = trainer(str(tmp_path), 4)
    assert second.resume() == 2
    assert float(second.state["cstate"].residual["embed.table"].abs().sum()
                 ) > 0
    hist = second.run()
    whole = trainer(None, 4)
    whole.resume()
    want = whole.run()
    assert "compress_residual_sq" in hist[-1]
    assert hist[-1]["loss"] == want[-1]["loss"]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b"])
def test_trainer_matches_reference(arch):
    """The slice as a whole: the reference ``Trainer`` and the port's,
    each from the reference's ``init_params(key(0))`` weights, 3 steps of
    seq 64 x batch 4 at lr 1e-3: the loss history within 2e-2 (measured
    <= 1.2e-3) and the grad norms within 2e-2 relative.  The reference's
    step is its own jitted program (XLA's default precision)."""
    cfg, jcfg = configs.get(arch).reduced(), J_ARCHS[arch].reduced()
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jt = JTrainer(j_build_model(jcfg), jcfg, JPAR,
                  JTrainConfig(steps=3, log_every=1, opt=JAdamWConfig(**opt)),
                  shape=JShapeCfg("t", "train", 64, 4))
    jt.init(seed=0)
    model = params_from_numpy(jax.tree.map(np.asarray, jt.state["params"]),
                              cfg, "cpu", PAR)
    want = jt.run()
    tr = Trainer(model, TrainConfig(steps=3, log_every=1,
                                    opt=AdamWConfig(**opt)),
                 shape=ShapeCfg("t", "train", 64, 4))
    got = tr.run()
    assert [m["step"] for m in got] == [m["step"] for m in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= 2e-2
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=2e-2)
        assert g["lr"] == pytest.approx(w["lr"], rel=1e-6)


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``:
    trains, checkpoints, and a second run with more steps resumes."""
    args = ["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
            "--seq", "32", "--batch", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    hist = launch_train.main(args + ["--steps", "2"]).history
    assert len(hist) == 2 and all(np.isfinite(m["loss"]) for m in hist)
    assert "remat=none resumed_at=0" in capsys.readouterr().out
    tr = launch_train.main(args + ["--steps", "3"])
    assert "resumed_at=2" in capsys.readouterr().out
    assert [m["step"] for m in tr.history] == [3]
    assert tr.model.par.remat == "none" and tr.pipeline.step == 3


def test_launcher_without_device_wants_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--arch", "qwen1.5-0.5b", "--reduced",
                           "--steps", "1"])
