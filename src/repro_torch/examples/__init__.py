"""The JAX package's five examples (``examples/*.py``) on the PyTorch port.

Each module keeps its original's docstring, steps, printed lines,
defaults and command-line flags, adds ``--device`` (default ``cuda``: the
hand-written kernels; ``cpu``: their plain versions), and runs as::

    PYTHONPATH=src python -m repro_torch.examples.<name>

- `quickstart`: task set, beam search, Eq. 3, the DES, then live EDF
  serving on the window kernel.
- `serve_edf`: FIFO against EDF on a mixed-criticality pair, live.
- `serve_gateway`: admission, shedding and a sharded gateway on a
  virtual clock.
- `dse_pipeline`: an LM's DSE, `provision`, and the pipeline executor on
  four stage ranks.
- `train_100m`: a ~100M-parameter model trained with checkpoints and
  resume.
"""
