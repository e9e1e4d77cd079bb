"""The port's whole-model gradient on the CPU against the reference's.

For each of the ten architectures at ``tiny_config``: the reference's
parameters carried across by ``params_from_jax``, the same numpy batch
(tokens, or codebook tokens; targets; patches where the model reads
them), and autograd through the port's ``loss_fn`` against
``jax.value_and_grad(repro.models.api.loss_fn)`` under
``single_device_ctx(remat="none")``.  The loss agrees within 1e-5
relative; every gradient leaf within 1e-4 of its largest magnitude,
tighter than the 2e-3 the forward is held to (seen: at most 6e-6, the
SSD and xLSTM recurrences the loosest).  Both packages run MoE blocks at
the config's own capacity factor.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import ARCHS, tiny_config as jtiny
from repro.models import api as japi
from repro.parallel.sharding import single_device_ctx
from repro_torch import _tree
from repro_torch.configs import get_arch, tiny_config
from repro_torch.models import api, transformer
from repro_torch.models.convert import params_from_jax

torch.set_num_threads(1)

LOSS_TOL = 1e-5     # relative
GRAD_TOL = 1e-4     # of each leaf's largest magnitude
CTX = single_device_ctx(remat="none")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_gradients_match_the_reference(arch):
    jcfg, cfg = jtiny(ARCHS[arch]), tiny_config(get_arch(arch))
    jp = japi.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(7)
    b, t = 2, 32
    batch = {"tokens": rng.integers(0, cfg.vocab_size, api.token_shape(
        cfg, b, t)).astype(np.int32),
        "targets": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)}
    if cfg.num_patches:
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: japi.loss_fn(p, jcfg, CTX, bb, jnp.float32),
        has_aux=True))(jp, {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    live = [p.requires_grad_(True) for p in _tree.leaves(params)]
    loss, m = transformer.loss_fn(params, cfg, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, live)

    assert abs(loss.item() - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert float(m["overflow"]) == float(jm["overflow"])
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    flat = _tree.flatten(params)
    assert [_tree.key(p) for p, _ in flat] == [
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p)
        for p, _ in jflat]
    for (path, _), g, (_, w) in zip(flat, grads, jflat):
        assert tuple(g.shape) == w.shape, path
        assert bool(torch.isfinite(g).all()), path
        assert _rel(g.numpy(), w) <= GRAD_TOL, (path, _rel(g.numpy(), w))
