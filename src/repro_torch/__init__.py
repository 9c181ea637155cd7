"""PyTorch/CUDA port of the tensorised HNSW index with real-time updates.

The package mirrors :mod:`repro` (the JAX reference) module for module:
``repro_torch.core.<name>`` matches ``repro.core.<name>`` and
``repro_torch.kernels.topk_dist`` matches ``repro.kernels.topk_dist``. It
imports ``torch`` and numpy only.

Entry points that create state (``empty_index``, ``from_arrays``, ``build``,
``build_batch``) take ``device=`` and default to ``"cuda"``; they raise when
no GPU is present unless the caller asks for ``device="cpu"``. Every other
function runs on the device of the tensors it is given.
"""
