"""The plain reference that decides ``correct``: plain PyTorch in float32
(TF32 off), no kernel, cache or batching of the program, and no import of
``vilgod_tpu_torch`` or of the JAX package. It works out again from the
benchmark's own inputs (frames, poses, seeded weights) what it compares,
following the program stage by stage from the program's ground masks and
cluster labels (see ``check.py``). ``control=True`` computes the same in
the precision below the configuration's: an fp8 (e4m3) tower for the
bf16 one, TF32 products for the float32 geometry."""
