"""The benchmark's yardstick, in plain NumPy and PyTorch.

Nothing here imports ``repro_torch``, ``repro`` or ``jax``:

  * ``data`` — a frozen copy of the clustered-Gaussian generator and the
    seed streams every run draws its inputs from;
  * ``exact`` — exact k-NN over a live set, the judge of every served
    answer, the live-set replay of an update stream, and the control (the
    same search in TF32 put in the program's place);
  * ``roofline`` — published H100 peaks and the least time of a masked
    ``topk_dist`` call.
"""
