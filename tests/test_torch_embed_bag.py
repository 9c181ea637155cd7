"""Port vs reference: the plain ``embed_bag`` against the JAX package's
Pallas kernel (interpret mode on the CPU) and its jnp oracle.

Tolerances: 1e-4 (relative and absolute) against the Pallas kernel, f32
and bf16 tables alike (both sum the table's values in f32), and against
the oracle for f32 tables. The oracle sums a bf16 table in bf16, so there
each output is held to the rounding bound of L bf16 additions,
``L * 2**-8 * sum_l |table[idx[b, l]]|`` (unit roundoff 2**-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embed_bag as j_embed_bag
from repro.kernels.embed_bag.ref import embed_bag_ref as j_embed_bag_ref

from repro_torch.kernels import embed_bag
from repro_torch.kernels.embed_bag import embed_bag_ref
from repro_torch.kernels.embed_bag.embed_bag import vector_loads

TOL = 1e-4
SHAPES = [(100, 8, 7, 4), (1000, 32, 37, 12), (513, 16, 8, 1),
          (2048, 64, 3, 33)]


def _inputs(v, d, b, l, all_pad_row=False):
    rng = np.random.default_rng(v + b)
    tab = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(-1, v, size=(b, l)).astype(np.int32)
    if all_pad_row:
        idx[0] = -1
    return tab, idx


@pytest.mark.parametrize("v,d,b,l", SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_plain_matches_pallas_and_oracle(v, d, b, l, mode):
    tab, idx = _inputs(v, d, b, l)
    out = embed_bag(torch.from_numpy(tab), torch.from_numpy(idx), mode)
    assert out.dtype == torch.float32 and out.shape == (b, d)
    jt, ji = jnp.asarray(tab), jnp.asarray(idx)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(j_embed_bag(jt, ji, mode)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(j_embed_bag_ref(jt, ji, mode)),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_all_padding_bag_is_zero(mode):
    tab, idx = _inputs(300, 16, 6, 9, all_pad_row=True)
    out = embed_bag(torch.from_numpy(tab), torch.from_numpy(idx), mode)
    assert (out[0] == 0).all()
    ref = np.asarray(j_embed_bag(jnp.asarray(tab), jnp.asarray(idx), mode))
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("v,d,b,l", SHAPES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bf16_table_sums_in_f32(v, d, b, l, mode):
    tab, idx = _inputs(v, d, b, l, all_pad_row=True)
    tab16 = torch.from_numpy(tab).to(torch.bfloat16)
    out = embed_bag(tab16, torch.from_numpy(idx), mode).numpy()
    jt = jnp.asarray(tab, jnp.bfloat16)
    ji = jnp.asarray(idx)
    np.testing.assert_allclose(out, np.asarray(j_embed_bag(jt, ji, mode)),
                               rtol=TOL, atol=TOL)
    # the oracle sums in bf16: hold it to L roundings at unit roundoff 2^-8
    absum = embed_bag_ref(tab16.abs(), torch.from_numpy(idx), mode).numpy()
    ref = np.asarray(j_embed_bag_ref(jt, ji, mode).astype(jnp.float32))
    assert (np.abs(out - ref) <= (l + 1) * 2.0 ** -8 * absum + 1e-6).all()


def test_out_of_range_indices_contribute_nothing():
    tab = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    idx = torch.tensor([[0, 4, -1, 2]], dtype=torch.int32)
    assert embed_bag(tab, idx).tolist() == [[6.0, 8.0, 10.0]]
    # "mean" counts every index >= 0, as the reference's wrapper does
    np.testing.assert_allclose(embed_bag(tab, idx, "mean").numpy(),
                               [[2.0, 8 / 3, 10 / 3]], rtol=1e-6)


def test_cpu_calls_never_count_and_wrapper_checks():
    from repro_torch.kernels.embed_bag.embed_bag import LIBRARY
    assert LIBRARY.lib is None
    before = embed_bag.launches
    embed_bag(torch.zeros((5, 4)), torch.zeros((2, 3), dtype=torch.int32))
    assert embed_bag.launches == before
    with pytest.raises(ValueError, match="mode"):
        embed_bag(torch.zeros((5, 4)), torch.zeros((2, 3), dtype=torch.int32),
                  "max")
    with pytest.raises(TypeError, match="integers"):
        embed_bag(torch.zeros((5, 4)), torch.zeros((2, 3)))
    meta = torch.empty((5, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        embed_bag(meta, torch.empty((2, 3), dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("dtype,d,ok", [
    (torch.float32, 4, True), (torch.float32, 6, False),
    (torch.float32, 260, True), (torch.bfloat16, 4, False),
    (torch.bfloat16, 8, True), (torch.bfloat16, 260, False),
    (torch.bfloat16, 32, True)])
def test_vector_loads_follow_the_widest_load(dtype, d, ok):
    """The kernel's widest load is 16 bytes a lane (4 f32, 8 bf16 values):
    a table takes it when its rows are a multiple of 16 bytes and it is
    16-byte aligned; a view one value into its storage is not."""
    flat = torch.zeros(64 * d + 1, dtype=dtype)
    assert vector_loads(flat[:-1].view(64, d)) == ok
    assert not vector_loads(flat[1:].view(64, d))


def test_variant_tool_patches_the_kernel_source():
    """``tools/embed_bag_variants.py`` times copies of the kernel's source
    with one change each (PERF.md's cache-policy, loads-in-flight and
    vocabulary-slab numbers): every change finds its anchor in the source
    as it is, and changes it."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "embed_bag_variants.py"
    spec = importlib.util.spec_from_file_location("embed_bag_variants", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = tool.SRC.read_text()
    out = tool.variants(src)
    assert out.pop("as_is") == src
    assert len(out) == 8 and all(v != src for v in out.values())
    assert "embed_bag_set_slabs" in out["slabs"]
