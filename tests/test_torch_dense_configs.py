"""Port parity: the dense configs starcoder2-7b, qwen1.5-32b and
command-r-plus-104b vs the reference (CPU, fp32).

Each config is a copy of the reference's fields, registered with the
port's registry; their layer plans and paged eligibility equal the
reference's.  At reduced size (2 layers, d_model 64; starcoder2-7b's
window clipped to 8) the port's forward, prefill and decode on the
reference's own initialised parameters (converted with
``repro_torch.convert``; the reference's functions under ``jax.jit``)
give its logits within TIGHT (2e-5): fp32 products summed in another
order by the two libraries.  command-r's LayerNorm carries a bias leaf
initialised to zeros and its block is parallel (one norm feeding attention
and MLP, no ``ln2``): both are held with the biases made non-zero.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.config import list_archs as jlist_archs
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.config import get_arch, list_archs
from repro_torch.models import transformer as TT

TIGHT = dict(rtol=2e-5, atol=2e-5)
DENSE = ["starcoder2-7b", "qwen1.5-32b", "command-r-plus-104b"]
NEW = DENSE + ["granite-moe-1b-a400m", "deepseek-v2-236b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TIGHT)


def _reduced(arch, seed=0):
    jc, tc = jget_arch(arch).reduced(), get_arch(arch).reduced()
    assert repr(jc) == repr(tc)
    jp = JT.init_params(jc, jax.random.key(seed))
    tp = convert.transformer_from_jax(_np(jp), tc, device="cpu")
    toks = np.random.default_rng(seed).integers(0, jc.vocab_size, (2, 13))
    return jc, tc, jp, tp, toks


@pytest.mark.parametrize("arch", DENSE)
def test_config_fields_equal_reference(arch):
    """Every field, the parameter counts and the family equal the
    reference's; the five configs of this family set are registered, and
    every registered arch is the reference's but the port's own
    deepseek-v2-lite."""
    tc, jc = get_arch(arch), jget_arch(arch)
    assert repr(tc) == repr(jc)
    assert tc.param_counts() == jc.param_counts()
    # every arch of the port's registry is the reference's, but the port's
    # own deepseek-v2-lite
    assert set(NEW) <= set(list_archs())
    assert set(list_archs()) - {"deepseek-v2-lite"} <= set(jlist_archs())


@pytest.mark.parametrize("arch", DENSE)
def test_plan_and_paged_eligibility_equal_reference(arch):
    """``check_supported`` accepts the full-size config; the layer plan
    (one repeated segment) and paged eligibility equal the reference's."""
    tc, jc = get_arch(arch), jget_arch(arch)
    TT.check_supported(tc)
    assert TT.plan_layers(tc) == JT.plan_layers(jc)
    assert TT.paged_eligible(tc) is JT.paged_eligible(jc) is True
    own = TT.init_params(tc.reduced(), torch.Generator().manual_seed(0),
                         device="cpu")
    jp = _np(JT.init_params(jc.reduced(), jax.random.key(0)))
    conv = convert.transformer_from_jax(jp, tc.reduced(), device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(own) == shapes(conv)


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_forward_matches_reference(arch):
    """Teacher-forced logits of the whole reduced stack."""
    jc, tc, jp, tp, toks = _reduced(arch)
    jl, _, _ = jax.jit(lambda p, t: JT.forward(jc, p, t))(
        jp, jnp.asarray(toks, jnp.int32))
    tl, _, aux = TT.forward(tc, tp, torch.as_tensor(toks))
    _close(tl, jl)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_prefill_decode_match_reference(arch):
    """``prefill`` (contiguous caches of capacity 16; starcoder2-7b's ring
    clipped to its window of 8) and three ``decode_step``s."""
    jc, tc, jp, tp, toks = _reduced(arch, seed=1)
    jl, jcaches = jax.jit(lambda p, t: JT.prefill(jc, p, t,
                                                  cache_capacity=16))(
        jp, jnp.asarray(toks, jnp.int32))
    tl, tcaches = TT.prefill(tc, tp, torch.as_tensor(toks),
                             cache_capacity=16)
    _close(tl, jl)
    jdecode = jax.jit(lambda p, c, t, i: JT.decode_step(jc, p, c, t, i))
    nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    for step in range(3):
        jl, jcaches = jdecode(jp, jcaches, jnp.asarray(nxt),
                              jnp.asarray(13 + step, jnp.int32))
        tl, tcaches = TT.decode_step(tc, tp, tcaches, torch.as_tensor(nxt),
                                     13 + step)
        _close(tl, jl)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    for t, j in zip(tcaches, convert.caches_from_jax(_np(jcaches), tc,
                                                     device="cpu")):
        assert torch.equal(t["pos"], j["pos"])
        _close(t["k"], j["k"].numpy())


def test_command_r_layernorm_bias_and_parallel_block():
    """command-r: every norm has a bias leaf (zeros when drawn), no layer
    has ``ln2``; with the norms' scales and biases made non-zero the
    parallel block still gives the reference's logits."""
    jc, tc, jp, tp, toks = _reduced("command-r-plus-104b", seed=2)
    assert tc.parallel_block and tc.norm == "layernorm"
    for layer in tp["layers"]:
        assert "ln2" not in layer and set(layer["ln1"]) == {"scale", "bias"}
        assert torch.all(layer["ln1"]["bias"] == 0)
    rng = np.random.default_rng(3)
    jseg = _np(jp)

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: (perturb(v) if k not in ("ln1", "final_norm") else
                        {n: np.asarray(a) + rng.normal(size=np.shape(a))
                         .astype(np.float32) * 0.3 for n, a in v.items()})
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [perturb(v) for v in tree]
        return tree

    jseg = perturb(jseg)
    tp = convert.transformer_from_jax(jseg, tc, device="cpu")
    assert torch.any(tp["layers"][0]["ln1"]["bias"] != 0)
    jl, _, _ = jax.jit(lambda p, t: JT.forward(jc, p, t))(
        jax.tree.map(jnp.asarray, jseg), jnp.asarray(toks, jnp.int32))
    tl, _, _ = TT.forward(tc, tp, torch.as_tensor(toks))
    _close(tl, jl)
