"""Shared set-up of the port's training parity tests
(``test_torch_train_*.py``, ``test_torch_checkpoint.py``): the reference's
parameters and batches made from one seed, carried into the port.

Batches come from ``lm_batches`` (the same numpy stream in both packages)
plus ``frames``/``patches`` from a numpy seed where the family takes them.
Gradient trees are compared in the port's layout: the reference's go
through ``convert.transformer_from_jax`` as its weights do.
"""
import jax
import numpy as np
import torch

from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.data import lm_batches


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def np_batch(cfg, B, S, seed=0):
    """One ``lm_batches`` batch with the family's extras, numpy."""
    batch = next(lm_batches(B, S, cfg.vocab_size, seed=seed, steps=1))
    rng = np.random.default_rng(seed + 100)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def ref_params(cfg, seed=0):
    """The reference's initial parameters (numpy leaves)."""
    return np_tree(jax.jit(lambda: JT.init_params(cfg, jax.random.key(seed)))())


def port_params(cfg, np_params):
    return convert.transformer_from_jax(np_params, cfg, "cpu")


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def flat(tree, path=""):
    """(path, tensor) pairs of a port tree, in order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in flat(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree) for pl in flat(v, f"{path}/{i}")]
    return [(path, tree)]


def as_f32(t):
    return t.detach().float().numpy()


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.detach().clone()


def assert_grads_close(got, want, rtol):
    """Every leaf of ``got`` within ``rtol`` times ``want``'s global norm
    of ``want`` (both port-layout trees)."""
    g, w = flat(got), flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    norm = float(np.sqrt(sum(np.sum(as_f32(t) ** 2) for _, t in w)))
    assert norm > 0
    for (path, a), (_, b) in zip(g, w):
        err = float(np.max(np.abs(as_f32(a) - as_f32(b)), initial=0.0))
        assert err <= rtol * norm, (path, err, norm)
