"""Stage 4, training: the trainer's step, as ``train/main.py`` builds it, back to back on host batches.

Set-up builds the policy (the frozen tower's and the trained weights drawn on the card from the seed), its
fresh AdamW state at count ``first_step`` (0: the trainer's own start, on the warmup's first learning rates),
the step and a pinned prefetch over a pool of ``pool_batches`` host batches of ``batch`` × ``window`` frames,
all drawn from the seed, and runs the first ``checked_steps`` steps through that feed: the reference follows
them (each step's loss, the first gradient as the optimizer took it, the parameters' change over them).  The
window goes on with the same state, feed and step.  ``train_step_ms`` is the window's time, ended by a
synchronise, over its steps.
"""

from __future__ import annotations

import gc
import itertools
import time

import numpy as np
import torch

from .. import roofline, weights
from ..reference import arpdt as ref
from ..trace import window_marker

BERT_VOCAB = 30522
MOMENT_B1 = 0.9


def flags(config: dict, params: dict):
    from arp_tpu_torch.config import Config
    from arp_tpu_torch.models.policy import get_policy_default_config

    model = {k: config[k] for k in ("model_type", "transfer_type", "use_adapter", "use_discrete_action",
                                    "emb_dim", "depth", "num_heads", "num_ensembles")}
    model["m3ae"] = {"model_type": None, "emb_dim": config["tower_width"], "depth": config["tower_depth"],
                     "num_heads": config["tower_heads"], "mlp_ratio": 4}
    return Config(dict(lr=config["lr"], lr_schedule="cos", warmup_epochs=params["warmup_epochs"],
                       epochs=params["epochs"], weight_decay=config["weight_decay"],
                       clip_gradient=config["clip_gradient"], explicit_l2_penalty=False, accum_steps=1),
                  model=get_policy_default_config(model), use_vl=True, vl_type="clip", patch_dim=config["patch"],
                  encode_image_size=0,
                  data=dict(use_task_reward=False, image_size=config["image_size"],
                            augmentations=config["augmentations"]))


def host_pool(config: dict, params: dict, seed: int, device) -> dict:
    """``pool_batches`` distinct host batches: uint8 frames, returns-to-go in [0, 1], actions."""
    k, b, t, s = params["pool_batches"], params["batch"], params["window"], config["image_size"]
    frames = weights.uint8_frames((k, b, t, s, s, 3), seed, device, stream=4).cpu().numpy()
    g = weights.generator(seed, device, stream=5)
    rtg = torch.rand((k, b, t, 1), generator=g, device=device).cpu().numpy()
    action = torch.randint(0, config["num_actions"], (k, b, t), generator=g, device=device).to(torch.int32)
    return {"image": frames, "rtg": rtg, "action": action.cpu().numpy()}


def host_batch(pool: dict, i: int) -> dict:
    """Batch ``i`` of the pool in the trainer's layout (``_host_batch_to_arrays``: no text, no goal)."""
    return {"image": {"ob": pool["image"][i]}, "rtg": {"ob": pool["rtg"][i]}, "action": pool["action"][i],
            "instruct": None, "text_padding_mask": None, "goal": None}


def build_policy(fl, config: dict, params: dict, seed: int, device, sample: dict | None = None):
    """The policy as the trainer builds it on ``device``, its lazy layers shaped by a first forward and every
    weight drawn from the seed: (model, trained names, the tower's weights, the trained weights), the
    weights as copies in the model's names."""
    from arp_tpu_torch.models import m3ae as m3ae_lib
    from arp_tpu_torch.parallel.step import trainable_parameters
    from arp_tpu_torch.train import common

    with torch.device(device):
        tower = m3ae_lib.MaskedMultimodalAutoencoder(fl.model.m3ae, text_vocab_size=BERT_VOCAB,
                                                     image_output_dim=config["patch"] ** 2 * 3)
    frozen = weights.fill(tower.named_parameters(), seed, device, stream=1)
    with torch.device(device):
        model = common.build_model(fl, config["num_actions"], pt_variables=frozen)
    model.to(device)
    del tower
    if sample is None:
        s = config["image_size"]
        sample = {"image": {"ob": np.zeros((1, 1, s, s, 3), np.uint8)}, "rtg": {"ob": np.zeros((1, 1, 1), np.float32)},
                  "action": np.zeros((1, 1), np.int32)}
    first = {k: (v if not isinstance(v, dict) else {kk: vv[:1] for kk, vv in v.items()})
             for k, v in sample.items() if v is not None}
    first["action"] = first["action"][:1]
    with torch.no_grad():
        model(first, deterministic=True)  # the lazy layers take their shapes, as at Flax's init
    named = trainable_parameters(model)
    trained = weights.fill(named, seed, device, stream=3)
    return model, [n for n, _ in named], {f"pt_model.{k}": v for k, v in frozen.items()}, trained


class Traffic:
    def __init__(self, config: dict, params: dict, seed: int, device, fault: str | None = None):
        from arp_tpu_torch.ops.augment import make_augment_fn
        from arp_tpu_torch.parallel.prefetch import ThreadedPrefetch, pin_batch
        from arp_tpu_torch.parallel.step import TrainState, make_train_step
        from arp_tpu_torch.train import common

        self.config, self.params, self.seed, self.device = config, params, seed, device
        fl = flags(config, params)
        self.steps_per_epoch = params["steps_per_epoch"]
        total = self.steps_per_epoch * fl.epochs
        self.warmup = min(int(fl.warmup_epochs * self.steps_per_epoch), total - 1)
        self.total = total
        schedule = common.build_lr_schedule(fl, self.steps_per_epoch, total)
        self.pool = host_pool(config, params, seed, device)
        model, self.trained, frozen, trained = build_policy(fl, config, params, seed, device, host_batch(self.pool, 0))
        state = TrainState.create(model, common.build_optimizer(fl, schedule, model))
        self.initial = {**frozen, **trained}
        self.first_step = params["first_step"]
        state.step = state.opt_state.count = self.first_step
        augment = make_augment_fn(fl.data.augmentations, image_size=config["image_size"],
                                  source_size=config["image_size"])
        loss_fn = common.make_loss_fn(model, augment, config["image_size"], False)
        if fault == "half_batch":
            loss_fn = _half_batch(loss_fn)
        self.model, self.state = model, state
        self.step = make_train_step(loss_fn, weight_decay=0.0, learning_rate_fn=schedule)
        pin = device.type == "cuda"
        k = params["pool_batches"]
        self.feed = ThreadedPrefetch((pin_batch(host_batch(self.pool, i % k), pin) for i in itertools.count()),
                                     capacity=2)
        self.losses = []
        self.first_mu = self.after = None
        for i in range(params["checked_steps"]):
            self._one()
            if i == 0:
                self.first_mu = {n: m.detach().clone() for n, m in zip(self.trained, state.opt_state.mu)}
        self.after = {n: p.detach().clone() for n, p in state.params}
        if fault == "unchanged":
            for (n, p), v in zip(state.params, self.after.values()):
                v.copy_(self.initial[n])
        self.checked = [float(v) for v in self.losses]
        self.losses = []
        if device.type == "cuda":
            torch.cuda.synchronize()

    def _one(self) -> None:
        from arp_tpu_torch.parallel.prefetch import batch_to_device

        batch = batch_to_device(next(self.feed), self.device)
        gen = ref.step_generator(self.seed, self.state.step, self.device)
        _, aux = self.step(self.state, batch, gen)
        self.losses.append(aux["loss"])

    def window(self, seconds: float, prof=None) -> dict:
        with window_marker(prof):
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                self._one()
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
        n = len(self.losses)
        finite = bool(torch.isfinite(torch.stack(self.losses)).all()) if n else False
        c, p = self.config, self.params
        frames = p["batch"] * p["window"]
        tower = roofline.vit_flops_per_frame(c["tower_width"], c["tower_depth"], c["patch"], c["image_size"], 0)
        tokens = (c["image_size"] // c["patch"]) ** 2 + 1
        policy = roofline.policy_flops_per_sequence(p["window"], c["emb_dim"], c["depth"], tokens,
                                                    c["tower_width"], c["num_actions"], c["num_ensembles"])
        work = {"model_flops": n * (frames * tower + 3 * p["batch"] * policy), "dtype": c["dtype"],
                "k1": {"64": [frames, tokens, c["tower_heads"], 64, c["dtype"]],
                       "16": [p["batch"], 3 * p["window"], c["num_heads"], c["emb_dim"] // c["num_heads"],
                              c["dtype"]]}}
        return {"metrics": {"train_step_ms": 1e3 * elapsed / max(n, 1)}, "attempted": n,
                "failed": 0 if finite else n, "work": work}

    def release(self) -> None:
        self.feed.close()
        self.program = {"losses": self.checked,
                        "grad": {n: m / (1 - MOMENT_B1) for n, m in self.first_mu.items()},
                        "after": self.after}
        del self.model, self.state, self.step, self.first_mu, self.after
        gc.collect()

    def _reference(self, tf32: bool = False) -> dict:
        c = dict(self.config, warmup_steps=self.warmup, total_steps=self.total)
        batches = [{"image": self.pool["image"][i], "rtg": self.pool["rtg"][i], "action": self.pool["action"][i]}
                   for i in range(self.params["checked_steps"])]
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            return ref.train_steps(self.initial, self.trained, batches, c, self.seed, self.first_step, self.device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before

    def _gaps(self, got: dict, want: dict, detail: bool = False) -> dict:
        """The three numbers compared: by the worst step the loss gap (relative); by the worst leaf the gap
        between the two sides' norms of the first gradient; and by the median leaf the gap between the two
        sides' norms of the parameters' change over the checked steps (the worst leaf's carries single entries
        of the small leaves whose update flips sign on rounding).  A leaf's gap is over the larger of the
        reference's norm of that leaf and of the median leaf.  A leaf whose reference gradient is under a
        thousandth of the median leaf's (it moves by round-off alone under Adam) is left out of the change.
        With ``detail`` also the readings that are not compared: each step's loss gap, the worst leaf's change
        gap and the change gaps' quartiles, and the leaves that read worst."""
        losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])]
        g_ref = {n: float(torch.linalg.vector_norm(g)) for n, g in want["first_grad"].items()}
        g_med = float(np.median(list(g_ref.values())))
        grad = {n: abs(float(torch.linalg.vector_norm(got["grad"][n])) - g_ref[n]) / max(g_ref[n], g_med)
                for n in g_ref}
        moved = [n for n in g_ref if g_ref[n] >= 1e-3 * g_med]
        d_ref = {n: float(torch.linalg.vector_norm(want["params"][n] - self.initial[n])) for n in moved}
        d_med = float(np.median(list(d_ref.values())))
        change = {n: abs(float(torch.linalg.vector_norm(got["after"][n] - self.initial[n])) - d_ref[n])
                  / max(d_ref[n], d_med) for n in moved}
        out = {"loss_gap": max(losses), "grad_gap": max(grad.values()),
               "change_gap": float(np.median(list(change.values())))}
        if detail:
            out.update(loss_gaps=losses, change_gap_worst_leaf=max(change.values()),
                       change_gap_quartiles=[float(q) for q in np.quantile(list(change.values()), (0.25, 0.5, 0.75))],
                       worst_grad_leaf=max(grad, key=grad.get), worst_change_leaf=max(change, key=change.get),
                       leaves_moved=len(moved))
        return out

    def compare(self) -> dict:
        self.want = self._reference()
        limits = self.params["limits"]
        return {k: (v, limits[k]) for k, v in self._gaps(self.program, self.want).items()}

    def detail(self) -> dict:
        """Every reading of the last ``compare``, the ones not compared too (calibrate.py prints them)."""
        return self._gaps(self.program, self.want, detail=True)

    def control(self) -> dict:
        low = self._reference(tf32=True)
        return self._gaps({"losses": low["losses"], "grad": low["first_grad"], "after": low["params"]},
                          self._reference(), detail=True)


def _half_batch(loss_fn):
    """A fault: the loss on the first half of the batch's rows, the mean taken over them alone."""
    def half(model, batch, generator):
        b = batch["action"].shape[0] // 2
        cut = {k: ({kk: vv[:b] for kk, vv in v.items()} if isinstance(v, dict) else
                   (None if v is None else v[:b])) for k, v in batch.items()}
        return loss_fn(model, cut, generator)

    return half
