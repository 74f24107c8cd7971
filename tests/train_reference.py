"""The reference's side of the train path's CPU tests: its loss and
gradients on the same weights and batch, and the comparison
``test_loss_and_grads_match_reference`` makes for one architecture
(``tests/test_torch_train.py`` and ``tests/test_torch_train_grads.py``
each hold half of the ten, so that ``--dist loadfile`` spreads them).
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as j_layers
from repro.configs import ARCHS as J_ARCHS
from repro.models.api import build_model as j_build_model
from repro.models.params import init_params as j_init_params
from repro.models.parallel import ParallelCfg as JParallelCfg
from repro_torch import configs
from repro_torch.models.common import materialize
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.parallel import ParallelCfg

STRICT = {"xla_allow_excess_precision": False}
JPAR = JParallelCfg(mesh=None, remat="none")
LOSS_TOL = 2e-2
GRAD_TOL = 5e-2
# ``Dskip`` enters as ``xh * cast(Dskip)[:, None]``, and XLA's CPU backend
# accumulates the transpose of that broadcast (a sum over B x S x P) in
# bf16 (see test_reference_sums_broadcast_transposes_in_bf16).
BF16_SUM_LEAVES = ("blocks.ssm.Dskip",)
# The ten archs' loss and gradients, split between test_torch_train.py and
# test_torch_train_grads.py by their time on one CPU worker.
TRAIN_ARCHS = ["llava-next-34b", "codeqwen1.5-7b", "deepseek-67b",
               "minitron-4b", "qwen1.5-0.5b", "kimi-k2-1t-a32b", "hymba-1.5b"]
GRAD_ARCHS = [a for a in configs.ALL_ARCHS if a not in TRAIN_ARCHS]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict)
                   else {name: np.asarray(jnp.asarray(v, jnp.float32))})
    return out


def _rel(got, want) -> float:
    """Relative Frobenius error ``|got - want| / |want|`` (0 when both
    are zero)."""
    d = np.linalg.norm(np.asarray(got, np.float64) - want)
    n = np.linalg.norm(np.asarray(want, np.float64))
    return float(d / n) if n else float(d)


def _jbatch(batch):
    return {k: (jnp.asarray(v.float().numpy(), jnp.bfloat16)
                if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
            for k, v in batch.items()}


def _reference_value_and_grad(jm, jcfg, jp, jb):
    """The reference's ``jax.value_and_grad(loss_fn)``, compiled STRICT."""
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, jcfg, JPAR)))
    return vg.lower(jp, jb).compile(compiler_options=STRICT)(jp, jb)


def check_loss_and_grads(arch, monkeypatch):
    """``Model.loss`` against ``jax.value_and_grad(loss_fn)`` on the
    reference's weights, seq 64, batch 2: the loss within 2e-2 and every
    gradient leaf within relative Frobenius 5e-2 (measured worst over the
    ten archs: loss 5.0e-4 (llava), gradient 1.8e-2 (qwen1.5-0.5b's and
    codeqwen's ``attn.bk``)).

    The exception is ``ssm.Dskip`` (mamba2, hymba), whose reference
    gradient is a bf16 sum over the activation (``BF16_SUM_LEAVES``): it
    is held within 5e-2 of the reference's gradient computed in float32
    (its ``COMPUTE_DTYPE`` set to float32, the same code), and the
    reference's own bf16 gradient must lie further from that than the
    port's (measured: port 2.3e-2 / 1.8e-2, reference 4.9e-2 / 4.8e-2;
    the port is 4.3e-2 / 5.3e-2 from the reference's bf16 gradient)."""
    jcfg, cfg = J_ARCHS[arch].reduced(), configs.get(arch).reduced()
    jm = j_build_model(jcfg)
    jp = j_init_params(jax.random.key(0), jm.defs)
    model = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                              ParallelCfg(remat="none"))
    batch = materialize(cfg, "train_4k", seq=64, batch=2, device="cpu")
    jb = _jbatch(batch)
    jloss, jgrads = _reference_value_and_grad(jm, jcfg, jp, jb)
    loss, grads = model.loss(batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL
    want = _flat(jgrads)
    assert list(grads) == [n for n, _ in model.named_parameters()]
    assert set(grads) == set(want)
    bad = {k: _rel(g.numpy(), want[k]) for k, g in grads.items()
           if k not in BF16_SUM_LEAVES
           and _rel(g.numpy(), want[k]) > GRAD_TOL}
    assert not bad, f"{arch}: gradient leaves off the reference's: {bad}"
    special = [k for k in BF16_SUM_LEAVES if k in grads]
    if special:
        monkeypatch.setattr(j_layers, "COMPUTE_DTYPE", jnp.float32)
        _, g32 = _reference_value_and_grad(jm, jcfg, jp, jb)
        exact = _flat(g32)
        for k in special:
            port, theirs = (_rel(grads[k].numpy(), exact[k]),
                            _rel(want[k], exact[k]))
            assert port <= GRAD_TOL, (k, port)
            assert theirs > port, (k, port, theirs)
