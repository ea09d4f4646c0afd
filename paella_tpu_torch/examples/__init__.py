"""The port's user-facing examples, the counterparts of the JAX repo's
`examples/generate.py`, `examples/train_minimal.py` and
`examples/eval_quality.py`, with their flags and defaults plus `--device`:

    python -m paella_tpu_torch.examples.generate [--vqgan v.pt --denoiser d.pt --byt5 b.pt]
    python -m paella_tpu_torch.examples.train_minimal --steps 20
    python -m paella_tpu_torch.examples.eval_quality [--w8a8-proxy [--ckpt d.pt]]

Each runs on the CUDA device unless it is given `--device cpu`, and raises
where no card is present otherwise. Without checkpoint files each runs the
tiny configuration on seeded random weights. Each module's `main(argv)`
returns what it made (images, the TrainState, proxy rows).
"""
