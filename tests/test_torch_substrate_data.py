"""The port's copies of the reference's configs and data generators, and the
bf16 carry, against the JAX package (on the CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.data import lm_token_batch as ref_lm_token_batch
from repro.data import recsys_batch as ref_recsys_batch
import repro_torch.configs as configs
from repro_torch.data import (PrefetchPipeline, SyntheticStream,
                              lm_token_batch, recsys_batch)
from repro_torch.models import tensor_from_numpy

RECSYS = ["wide_deep", "autoint", "dien", "sasrec"]


def test_registry_lists_the_same_archs():
    assert configs.ARCHS == ref_configs.ARCHS
    assert configs._ALIASES == ref_configs._ALIASES


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_configs_equal_the_reference_field_for_field(arch):
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.get_smoke_config,
                          ref_configs.get_smoke_config)):
        ours, ref = get(arch), ref_get(arch)
        assert type(ours).__name__ == type(ref).__name__
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        for prop in ("head_dim", "vocab_padded", "items_padded"):
            if hasattr(ref, prop):
                assert getattr(ours, prop) == getattr(ref, prop)
        if hasattr(ref, "param_count"):
            assert ours.param_count() == ref.param_count()
            assert ours.active_param_count() == ref.active_param_count()
        assert configs.shapes_for(ours).keys() == \
            ref_configs.shapes_for(ref).keys()


def test_aliases_resolve_and_unknown_archs_raise():
    for alias in ref_configs._ALIASES:
        assert dataclasses.asdict(configs.get_config(alias)) == \
            dataclasses.asdict(ref_configs.get_config(alias))
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")
    with pytest.raises(TypeError):
        configs.shapes_for(object())


@pytest.mark.parametrize("table", ["LM_SHAPES", "GNN_SHAPES",
                                   "RECSYS_SHAPES"])
def test_shape_tables_equal_the_reference(table):
    ours, ref = getattr(configs, table), getattr(ref_configs, table)
    assert ours.keys() == ref.keys()
    for name in ref:
        assert dataclasses.asdict(ours[name]) == dataclasses.asdict(ref[name])


@pytest.mark.parametrize("vocab,batch,seq,seed", [(256, 4, 16, 0),
                                                  (100352, 8, 127, 9),
                                                  (7, 3, 1, 123)])
def test_lm_token_batch_equals_the_reference(vocab, batch, seq, seed):
    ours = lm_token_batch(vocab, batch, seq, seed)
    ref = ref_lm_token_batch(vocab, batch, seq, seed)
    assert ours.dtype == ref.dtype == np.int32
    assert ours.shape == (batch, seq + 1)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("arch", RECSYS)
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_recsys_batch_equals_the_reference(arch, smoke):
    get = configs.get_smoke_config if smoke else configs.get_config
    ref_get = (ref_configs.get_smoke_config if smoke
               else ref_configs.get_config)
    for seed in (0, 1, 7):
        ours = recsys_batch(get(arch), 64, seed)
        ref = ref_recsys_batch(ref_get(arch), 64, seed)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k])


def test_recsys_batch_ids_lie_in_the_kernels_range():
    """wide-deep's bag ids lie in [-1, V): the range on which the port's
    ``embed_bag`` and the reference's gather-sum compute one function."""
    cfg = configs.get_smoke_config("wide-deep")
    bag = recsys_batch(cfg, 512, 3)["bag_ids"]
    assert bag.min() == -1 and bag.max() < cfg.vocab_size
    assert 0.25 < (bag < 0).mean() < 0.35


def test_stream_determinism_and_resume():
    mk = lambda step: {"x": np.full(3, step)}
    s1 = SyntheticStream(mk, 0)
    batches = [next(s1) for _ in range(5)]
    assert [int(b["x"][0]) for b in batches] == list(range(5))
    st = s1.state_dict()
    s2 = SyntheticStream(mk, 0)
    s2.load_state_dict(st)
    np.testing.assert_array_equal(next(s2)["x"], np.full(3, 5))


def test_prefetch_pipeline_order():
    it = iter([{"i": i} for i in range(10)])
    out = [b["i"] for b in PrefetchPipeline(it, depth=3)]
    assert out == list(range(10))


def test_prefetch_pipeline_over_a_token_stream():
    stream = SyntheticStream(lambda step: lm_token_batch(256, 2, 7, step))
    pipe = PrefetchPipeline(iter(stream), depth=2)
    for step in range(4):
        np.testing.assert_array_equal(next(pipe),
                                      ref_lm_token_batch(256, 2, 7, step))


def test_bf16_carry_is_bit_for_bit():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(64, 33)) * 10.0 ** rng.integers(
        -40, 38, size=(64, 33)), jnp.bfloat16)
    specials = jnp.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40,
                            -3e38, 2 ** -133], jnp.bfloat16)
    for a in (x, specials, x.T):
        host = np.asarray(a)
        assert host.dtype == ml_dtypes.bfloat16
        t = tensor_from_numpy(host, "cpu")
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == host.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.ascontiguousarray(host).view(
                                          np.int16))
        back = jnp.asarray(t.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
        np.testing.assert_array_equal(
            np.asarray(jax.lax.bitcast_convert_type(back, jnp.int16)),
            np.asarray(jax.lax.bitcast_convert_type(a, jnp.int16)))


def test_f32_and_int_carry():
    a = np.asarray(jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7)
    t = tensor_from_numpy(a, "cpu")
    assert t.dtype == torch.float32 and np.array_equal(t.numpy(), a)
    i = tensor_from_numpy(np.arange(5, dtype=np.int32), "cpu")
    assert i.dtype == torch.int32
