"""The `train_step` of `train.make_train_step`, back to back: each step a new
batch made on the card from the mix's seed (images, conditioning and every
draw pinned through `train.Draws`), then one optimizer update.

Set-up builds the step, its model and its optimizer state once and drives
that same object through the check's first steps (`check.steps`), on the
mix's first batches through the window's own call; the window goes on from
there. The program's numbers of those steps are kept small: each step's
loss, the per-leaf norms of the first gradient as AdamW holds it (mu / (1 -
b1) after step 1) and of the parameters' change over the steps. After the
window the reference follows the same steps from the same seeds.

Check parameters: steps. The reference runs each batch in microbatches of
MICRO images, which the f32 reference's activations fit at the cell's size.
"""
from __future__ import annotations

import torch

from bench_port.core import traffic, weights
from bench_port.reference import training as ref_training

B1 = 0.9
MICRO = 2


class Entry:
    def __init__(self, run):
        self.run = run
        spec, built = run.spec, run.built
        self.config = spec["config"]
        dz = self.config["parts"]["denoiser"]["sizes"]
        self.mix = dict(spec["traffic"], byt5_embd=dz["byt5_embd"], clip_embd=dz["clip_embd"])
        f = 2 * 2 ** (self.config["parts"]["codec"]["sizes"]["levels"] - 1)
        self.latent_hw = (self.mix["image_hw"] // f,) * 2
        self.model, self.state, self.train_step = built["model"], built["state"], built["step"]
        self.gen = traffic.generator(spec["traffic"], run.seed)
        self.null = self._null(traffic.null_cond(self.mix, run.seed, run.device))
        self.steps_done = 0
        self.check_seeds: list = []
        self.numbers: dict = {}

    def _null(self, n: dict):
        from paella_tpu_torch.train import NullCond

        return NullCond(n["byt5"], n["byt5_mask"], n["clip"])

    def _batch(self, batch_seed: int):
        from paella_tpu_torch.train import Batch, Draws

        b = traffic.train_batch(self.mix, self.config["train"], self.config["parts"]["denoiser"]["sizes"]["num_labels"],
                                self.latent_hw, batch_seed, self.run.device)
        batch = Batch(b["images"], b["byt5"], b["byt5_mask"], b["clip"], b["clip_image"])
        draws = Draws(b["drop_byt5"], b["drop_clip"], b["drop_image"], b["u"], b["noise_mask"], b["random_x"],
                      b["dropout_seed"])
        return batch, [draws]

    def _step(self) -> dict:
        call = self.gen.next()
        batch, draws = self._batch(call["batch_seed"])
        with self.run.spans("step"):
            out = self.train_step(self.state, batch, self.null, draws)
        self.steps_done += 1
        return call, out

    def warmup(self):
        """The check's steps, through the window's own call."""
        n = int(self.run.spec["check"]["steps"])
        params = dict(self.model.named_parameters())
        losses = []
        for i in range(n):
            call, out = self._step()
            self.check_seeds.append(call["batch_seed"])
            losses.append(float(out["loss"]))
            if i == 0:
                # the first gradient as AdamW holds it; a step that left no
                # moments behind holds a gradient of nought
                opt = self.state.optimizer
                self.numbers["grad_norms"] = {
                    k: float(opt.state[p]["mu"].float().norm()) / (1.0 - B1) if "mu" in opt.state[p] else 0.0
                    for k, p in params.items()}
        start = weights.regenerate(self.run.built_layouts["denoiser"], self.config["parts"]["denoiser"].get("init"),
                                   self.run.seed, "denoiser", self.run.device)
        self.numbers["change_norms"] = {k: float((p.detach() - start[k].to(p.dtype)).norm()) for k, p in params.items()}
        del start
        self.numbers["losses"] = losses

    def step(self, i: int) -> int:
        self._step()
        return int(self.mix["images"])

    def end_to_end(self, window_s: float, images: int) -> dict:
        return {"train_images_per_s": images / window_s}

    def release(self):
        self.model = self.state = self.train_step = None

    def check(self, device) -> dict:
        run = self.run
        sd = run.builder.reference_weights(self.config, run.built_layouts, run.seed, device)
        self.reference = follow(self.config, sd, self.mix, self.latent_hw, run.seed, self.check_seeds, MICRO, device)
        return compare(self.numbers, self.reference)

    def flop_counter(self):
        from bench_port.reference.flops import TrainFlops

        sizes = {p: self.config["parts"][p]["sizes"] for p in self.config["parts"]}
        return TrainFlops(sizes, self.run.built_layouts, self.mix, self.latent_hw)

    def flops(self, fl, first: int, stop: int) -> float:
        """Model FLOPs of the steps numbered first to stop - 1."""
        return fl.step() * (stop - first)


def follow(config: dict, sd: dict, mix: dict, latent_hw: tuple, seed: int, batch_seeds: list, micro: int, device,
           cast=None, rows: int = 0) -> dict:
    """The reference through the same steps: losses, the first step's
    clipped gradient's and the steps' change's per-leaf norms. `cast` runs
    the products in a lower precision, `rows` keeps only a batch's first rows
    (both for the control and the planted faults)."""
    sizes = {p: config["parts"][p]["sizes"] for p in config["parts"]}
    train = config["train"]
    c_latent = sizes["codec"]["c_latent"]
    bn = (torch.zeros(c_latent, device=device), torch.ones(c_latent, device=device))
    null = traffic.null_cond(mix, seed, device)
    trainer = ref_training.Trainer(sd["denoiser"], train)
    start = {k: v.detach().float() for k, v in sd["denoiser"].items()}
    losses, grad_norms = [], None
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for i, bs in enumerate(batch_seeds):
            batch = traffic.train_batch(mix, train, sizes["denoiser"]["num_labels"], latent_hw, bs, device)
            if rows:
                batch = {k: v[:rows] if torch.is_tensor(v) and v.dim() else v for k, v in batch.items()}
            loss, grads = trainer.step(sizes, sd["codec"], bn, batch, null, micro, cast=cast)
            losses.append(loss)
            if i == 0:
                grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            del grads
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    change = {k: float((p.detach() - start[k]).norm()) for k, p in trainer.params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def leaf_gaps(got: dict, want: dict, skip: set) -> dict:
    """Each kept leaf's |norm got - norm want| over the larger of its norm
    want and the median leaf's."""
    kept = [k for k in want if k not in skip]
    med = _median([want[k] for k in kept])
    return {k: abs(got[k] - want[k]) / max(want[k], med) for k in kept}


def _worst(gaps: dict) -> list:
    k = max(gaps, key=gaps.get)
    return [k, gaps[k]]


def compare(prog: dict, ref: dict) -> dict:
    g = ref["grad_norms"]
    med = sorted(g.values())[len(g) // 2]
    # leaves whose gradient is nought to rounding in the reference move
    # under Adam by round-off alone: left out by this rule, never by name
    skip = {k for k, v in g.items() if v < 1e-3 * med}
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grads = leaf_gaps(prog["grad_norms"], g, skip)
    changes = leaf_gaps(prog["change_norms"], ref["change_norms"], skip)
    return {
        "loss_gap": max(losses),
        "grad_leaf_gap": max(grads.values()),
        "update_leaf_gap": max(changes.values()),
        "first_loss_gap": losses[0],
        "leaves_left_out": len(skip),
        "worst_grad_leaf": _worst(grads),
        "worst_update_leaf": _worst(changes),
        "losses_program": prog["losses"],
        "losses_reference": ref["losses"],
    }


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2] if xs else float("nan")
