"""The sharded MoE dispatch (``transformer._moe_ffn_sharded``, picked by
``moe_ffn`` under ``dist_ctx.use_mesh``) against the reference's
``shard_map`` form (its ``moe_ffn`` under its mesh, jitted) on host
meshes ``(data, model)`` of ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` (bf16 on
``(2, 2)``): granite's smoke config splits every expert's
FFN columns over ``model`` (``moe_shard="ffn"``), deepseek's splits its
experts (``"expert"``). The reference runs in one subprocess with four
forced host devices (``XLA_FLAGS`` set before ``import jax``, as
``tests/test_distributed.py`` does); the port runs its one-process form
over a grid of CPU devices. f32 at 1e-5, bf16 as shipped at 2e-2.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_grid
from repro_torch.models import dist_ctx, transformer
from torch_train_parity import lm_pair

SRC = str(Path(__file__).resolve().parents[1] / "src")
MESHES = [(2, 2), (1, 4), (4, 1)]
MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
T = 64

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
import jax.numpy as jnp
import numpy as np
from repro.configs import get_smoke_config
from repro.models import dist_ctx, transformer

assert len(jax.devices()) == 4
z = np.load(sys.argv[1])
out = {}
for arch in ("granite-moe-3b-a800m", "deepseek-moe-16b"):
    cfg = get_smoke_config(arch)
    rp = transformer.init_params(cfg, jax.random.PRNGKey(1))
    for f32 in (0, 1):
        p = jax.tree.map(lambda a: a.astype(jnp.float32), rp) if f32 else rp
        lp = jax.tree.map(lambda a: a[0], p["layers"])
        x = jnp.asarray(z["x"], jnp.float32 if f32 else jnp.bfloat16)
        # every mesh in f32; bf16 as shipped, and 63 tokens (which do not
        # split over a data axis of 2), on (2, 2)
        for d, m in ((2, 2), (1, 4), (4, 1)) if f32 else ((2, 2),):
            mesh = jax.make_mesh((d, m), ("data", "model"))
            key = f"{arch}/{f32}/{d}x{m}"

            def under_mesh(lp, x):
                with dist_ctx.use_mesh(mesh):
                    return transformer.moe_ffn(cfg, lp, x)
            y, aux = jax.jit(under_mesh)(lp, x)
            out[key + "/y"] = np.asarray(y, np.float32)
            out[key + "/aux"] = np.asarray(aux)
            if (d, m) == (2, 2):
                y, _ = jax.jit(under_mesh)(lp, x[:63])
                out[key + "/odd"] = np.asarray(y, np.float32)
np.savez(sys.argv[2], **out)
print("reference sharded MoE OK")
"""


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_sharded")
    x = np.random.default_rng(0).normal(size=(T, 64)).astype(np.float32)
    np.savez(tmp / "in.npz", x=x)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                           str(tmp / "in.npz"), str(tmp / "out.npz")],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(tmp / "out.npz") as z:
        return x, {k: z[k] for k in z.files}


def _case(arch, f32, x):
    _, _, pcfg, params = lm_pair(arch, f32)
    lp = {k: v[0] for k, v in params["layers"].items()}
    xt = torch.from_numpy(x).to(torch.float32 if f32 else torch.bfloat16)
    tol = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=2e-2, atol=2e-2)
    return pcfg, lp, xt, tol


@pytest.mark.parametrize("mesh,f32", [(m, True) for m in MESHES]
                         + [((2, 2), False)],
                         ids=[f"{m[0]}x{m[1]}-f32" for m in MESHES]
                         + ["2x2-bf16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_sharded_form_matches_the_reference(ref_runs, arch, f32, mesh):
    x, ref = ref_runs
    pcfg, lp, xt, tol = _case(arch, f32, x)
    assert pcfg.moe_shard == ("ffn" if arch.startswith("granite")
                              else "expert")
    grid = make_grid(*mesh, device="cpu")
    key = f"{arch}/{int(f32)}/{mesh[0]}x{mesh[1]}"
    with dist_ctx.use_mesh(grid):
        y, aux = transformer.moe_ffn(pcfg, lp, xt)
        odd, _ = transformer.moe_ffn(pcfg, lp, xt[:63])
    assert y.dtype == xt.dtype and y.shape == xt.shape
    np.testing.assert_allclose(y.float().numpy(), ref[key + "/y"], **tol)
    np.testing.assert_allclose(float(aux), float(ref[key + "/aux"]),
                               rtol=1e-6)
    if key + "/odd" in ref:
        np.testing.assert_allclose(odd.float().numpy(), ref[key + "/odd"],
                                   **tol)
    # the sharded form is what moe_ffn took; 63 tokens that do not divide
    # the data axis take the one-block form
    routed, aux2 = transformer._moe_ffn_sharded(pcfg, lp, xt, grid)
    if pcfg.num_shared_experts:
        routed = routed + transformer.swiglu(xt, lp["ws_gate"], lp["ws_up"],
                                             lp["ws_down"])
    assert torch.equal(routed, y) and torch.equal(aux, aux2)
    if mesh[0] > 1:
        assert torch.equal(odd, transformer.moe_ffn(pcfg, lp, xt[:63])[0])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_one_data_block_equals_the_unsharded_call(arch):
    """On a 1 x 4 grid every token is one block with the unsharded
    capacity, so the sharded form computes the same function; only the
    sum of the model slices rounds differently (f32)."""
    pcfg, lp, xt, tol = _case(arch, True,
                              np.random.default_rng(3).normal(
                                  size=(T, 64)).astype(np.float32))
    whole, aux = transformer.moe_ffn(pcfg, lp, xt)
    with dist_ctx.use_mesh(make_grid(1, 4, device="cpu")):
        assert dist_ctx.current_mesh() is not None
        parts, aux2 = transformer.moe_ffn(pcfg, lp, xt)
    assert dist_ctx.current_mesh() is None
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), **tol)
    assert float(aux) == float(aux2)


def test_grid_lays_out_this_hosts_devices():
    assert make_grid(2, 3, device="cpu") == [[torch.device("cpu")] * 3] * 2
    with pytest.raises(ValueError):
        make_grid(0, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            make_grid(1, 4)


def test_a_model_axis_that_does_not_divide_takes_the_one_block_form():
    """granite's smoke d_ff (32) does not split 3 ways, deepseek's 8
    experts do not split 3 ways: ``moe_ffn`` keeps the one-block form, as
    the reference's divisibility test does."""
    for arch in MOE_ARCHS:
        pcfg = get_smoke_config(arch)
        params = transformer.init_params(pcfg, seed=1, device="cpu")
        lp = {k: v[0] for k, v in params["layers"].items()}
        xt = torch.randn(12, pcfg.d_model,
                         generator=torch.Generator().manual_seed(0)).bfloat16()
        with dist_ctx.use_mesh(make_grid(2, 3, device="cpu")):
            y, _ = transformer.moe_ffn(pcfg, lp, xt)
        assert torch.equal(y, transformer.moe_ffn(pcfg, lp, xt)[0])
