"""The mesh in scope: lets model code take its sharded form (the MoE
dispatch) without threading a mesh through every call, as the reference's
``models/dist_ctx.py`` does.

A mesh here is a ``[data][model]`` grid of ``torch.device``s
(``launch.mesh.make_grid``), standing for the reference's
``Mesh(devices, ("data", "model"))``; ``None`` (the default) takes the
one-block paths.
"""
from __future__ import annotations

import contextlib
import contextvars

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(tok)
