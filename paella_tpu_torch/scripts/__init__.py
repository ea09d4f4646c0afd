"""The port's production entry points, the counterparts of the JAX repo's
`scripts/run_driver_e2e.py`, `scripts/run_codec_pretrain.py` and
`scripts/run_eval_e2e.py`, with their flags, defaults, files and last-line
JSON summaries:

    python -m paella_tpu_torch.scripts.run_codec_pretrain --workdir runs/codec --steps 2000
    python -m paella_tpu_torch.scripts.run_driver_e2e --workdir runs/driver --geometry 1b \\
        --adam-moments bf16 --batch 8 --codec runs/codec/codec_vars.npz
    python -m paella_tpu_torch.scripts.run_eval_e2e --workdir runs/driver --geometry 1b \\
        --adam-moments bf16 --byt5 bf16 --n 256 --trend

Each runs on the CUDA device unless it is given `--smoke` (the tiny
geometry on the CPU) or `--device cpu`, and raises where no card is present
otherwise. Weights are seeded at the real geometries (ByT5-XL, CLIP
ViT-H-14, the Paella configs of `make_geometry`, VQConfig(), InceptionV3):
no checkpoint is read but the runs' own.
"""
