"""Phasic Policy Gradient on GPUs: expert training for demo collection (port of arp_tpu/collect/ppg.py).

The reference's torch + MPI PPG stack (phasic_policy_gradient/{ppg,ppo,roller}.py), as the JAX package
re-designed it:

  * :class:`PhasicValueModel`: Impala-CNN policy and value with the "dual" architecture (separate pi
    and vf encoders, an auxiliary value head on the pi encoder), or "shared" / "detach" (one encoder;
    the value head reads it, or its detached output).  Parameter names are Flax's
    (``pi_enc.stack0_firstconv.weight``), so :func:`arp_tpu_torch.collect.convert_ppg.flax_ppg_to_torch`
    is a transpose of each kernel.  Given the frame shape it materializes the Impala stack's lazy
    input layers and initializes every weight from a ``torch.Generator`` as Flax's initializers
    draw them: lecun-normal (truncated) convolutions and dense layers, zero biases, the heads
    ``orthogonal(0.1)``;
  * the policy phase: PPO with GAE advantages, the clipped surrogate, value and entropy losses over
    minibatched epochs; ``ppo_epochs == vf_epochs`` is one combined objective and one optimizer,
    otherwise vf epochs then pi epochs, each phase with its own persistent Adam state;
  * the auxiliary phase every ``n_pi`` iterations: the value function distilled into the aux head
    while the policy is KL-cloned to its own logits over the buffered segments;
  * :class:`Roller` steps N host envs in lockstep, :class:`Gym3Roller` one vectorized gym3 venv
    (the port's ``envs/gym3_stub.py`` or its C++ ``envs/native_engine.py``), with batched inference
    on the device.

Adam is ``train/common.py::AdamW`` with no weight decay, no clipping and a constant learning rate:
``optax.adam`` bit for bit.  A parameter the loss does not reach gets a zero gradient, not None, so
its moments decay and it stays exactly still, as under optax.

Each step's frames (``uint8 / 255`` float32 on the host, as the JAX package's) are copied to the card
once, through a pinned buffer, and the segment's minibatches and the aux phase index them there;
the aux phase's logits over the whole buffer are computed in chunks of ``LOGITS_CHUNK`` frames.

What differs from the JAX package, on purpose:
  * actions are drawn with ``torch.multinomial`` from a generator seeded by (seed, iteration), so a
    resumed run draws as an uninterrupted one would; they are reproducible, not JAX's bits;
  * checkpoints (``checkpoint_dir``) are the port's ``step_<n>.pt`` files
    (``checkpoint.py::CheckpointManager``, ``n`` the iteration) holding the model, the combined
    optimizer, the phase optimizers, the reward normalizer, the iteration and the history.  As in
    JAX, the envs and the aux phase's segment buffer are not saved: a resumed run re-warms its
    envs.

Several processes (``mesh``, parallel/mesh.py; JAX's multi-process contract): each rank rolls its own
``num_envs`` envs with ``env_seed = seed + rank * 100003``, the params start identical (rank 0's are
broadcast), reward normalization and advantage whitening stay per rank, and every minibatch's
gradients are averaged over the ranks before the Adam step, so the update sees every rank's data as
JAX's global batch does; the records' values are averaged over the ranks too.  The average is one
all-reduce of the flat gradients, not a ``DistributedDataParallel`` wrapper: the phases' losses reach
different parameters from the same forward's outputs (the pi phase leaves the value head without a
gradient), which DDP's search for unused parameters, run from the outputs, cannot see.
Checkpointing under several processes raises, as JAX asserts.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..models.impala import ImpalaCNN
from ..parallel.step import TrainState
from ..train.common import AdamW, AdamWState
from .reward_normalizer import RewardNormalizer

# 1 / std of a standard normal truncated to [-2, 2]: Flax's truncated lecun-normal correction
_TRUNC_STD = 0.87962566103423978
# frames a forward of logits_of: the aux phase's whole buffer (n_pi segments) does not fit one
LOGITS_CHUNK = 4096


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """``nn.initializers.lecun_normal()``: truncated normal, variance 1 / fan_in (fan_in = the
    input channels times the kernel's window: one output's weights)."""
    std = (1.0 / weight[0].numel()) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
    weight.mul_(std)


class PhasicValueModel(nn.Module):
    """(B, H, W, C) frames in [0, 1] -> (logits, value, aux_value).

    ``frame_shape`` (H, W, C): run the lazy input layers once and draw every weight from
    ``generator`` (seed 0 when None) as Flax's initializers do.  Without it the model stays lazy
    until its first forward, with torch's own initialization (a state dict is loaded after)."""

    def __init__(self, num_actions: int = 15, arch: str = "dual", pool_padding: str = "same",
                 frame_shape: Optional[tuple] = None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if arch not in ("dual", "shared", "detach"):
            raise ValueError(f"arch must be dual, shared or detach, got {arch!r}")
        self.num_actions, self.arch, self.pool_padding = num_actions, arch, pool_padding
        self.pi_enc = ImpalaCNN(pool_padding=pool_padding)
        if arch == "dual":
            self.vf_enc = ImpalaCNN(pool_padding=pool_padding)
        self.pi_head = nn.Linear(256, num_actions)
        self.vf_head = nn.Linear(256, 1)
        self.aux_vf_head = nn.Linear(256, 1)
        if frame_shape is not None:
            self.materialize(frame_shape)
            self.init_flax(generator if generator is not None else torch.Generator().manual_seed(0))

    def materialize(self, frame_shape: tuple) -> None:
        """Give the lazy input layers their shapes from one (1, H, W, C) frame, leaving torch's global
        random state as it was."""
        with torch.random.fork_rng(devices=[]), torch.no_grad():
            self(torch.zeros((1, *frame_shape)))

    @torch.no_grad()
    def init_flax(self, generator: torch.Generator) -> None:
        """Every weight drawn as Flax's ``PhasicValueModel.init`` draws it (not its bits)."""
        encoders = [self.pi_enc] + ([self.vf_enc] if self.arch == "dual" else [])
        for enc in encoders:
            for module in enc.modules():
                if isinstance(module, (nn.Conv2d, nn.Linear)):
                    _lecun_normal_(module.weight, generator)
                    module.bias.zero_()
        for head in (self.pi_head, self.vf_head, self.aux_vf_head):
            nn.init.orthogonal_(head.weight, gain=0.1, generator=generator)
            head.bias.zero_()

    def forward(self, obs):
        pi_x = self.pi_enc(obs)
        logits = self.pi_head(pi_x)
        aux_value = self.aux_vf_head(pi_x)[..., 0]
        if self.arch == "dual":
            vf_x = self.vf_enc(obs)
        elif self.arch == "detach":
            vf_x = pi_x.detach()
        else:
            vf_x = pi_x
        value = self.vf_head(vf_x)[..., 0]
        return logits, value, aux_value

    # what checkpoint.py's CheckpointManager saves and restores
    def trained_state_dict(self) -> dict:
        return self.state_dict()

    def load_trained_state_dict(self, state: dict) -> None:
        self.load_state_dict(state)


def compute_gae(rewards, values, dones, last_value, gamma=0.999, lam=0.95):
    """Generalized advantage estimation over a (T, N) segment (ppo.py:21-46), in numpy on the host."""
    T = rewards.shape[0]
    values_ext = np.concatenate([values, last_value[None]], axis=0)
    adv = np.zeros_like(rewards)
    lastgaelam = 0.0
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * values_ext[t + 1] * nonterminal - values_ext[t]
        lastgaelam = delta + gamma * lam * nonterminal * lastgaelam
        adv[t] = lastgaelam
    return adv, adv + values


@dataclasses.dataclass
class PPGConfig:
    num_envs: int = 8
    segment_length: int = 64
    gamma: float = 0.999
    lam: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    vf_coef: float = 0.5
    lr: float = 5e-4
    ppo_epochs: int = 1        # reference e_pi
    vf_epochs: int = 1         # reference e_vf
    minibatches: int = 4
    n_pi: int = 8              # policy-phase iterations per aux phase
    aux_epochs: int = 6        # reference e_aux
    aux_minibatches: int = 4
    beta_clone: float = 1.0
    arch: str = "dual"
    # backward-discounted running reward normalization (reference ppo.py:158, rnorm=True by default)
    reward_norm: bool = True


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Roller:
    """Vectorized segment collector over host envs (roller.py:11-168).

    ``act_fn(frames, generator) -> (actions, logps, values)`` takes the (N, H, W, C) float32 frames
    and the generator ``collect`` was given (numpy or tensors back)."""

    def __init__(self, envs, act_fn: Callable, seed: int = 0):
        self.envs = envs
        self.act_fn = act_fn
        self.obs = [e.reset(seed + i) for i, e in enumerate(envs)]
        self.ep_returns: list = []
        self._running = np.zeros(len(envs))
        self._seed = seed + len(envs)

    def _frames(self):
        key = self.envs[0].config.image_key.split(", ")[0]
        return np.stack([np.asarray(o["image"][key], np.float32) / 255.0 for o in self.obs])

    def collect(self, generator, T: int):
        n = len(self.envs)
        key0 = self._frames()
        obs_buf = np.zeros((T,) + key0.shape, np.float32)
        act_buf = np.zeros((T, n), np.int32)
        rew_buf = np.zeros((T, n), np.float32)
        done_buf = np.zeros((T, n), np.float32)
        logp_buf = np.zeros((T, n), np.float32)
        val_buf = np.zeros((T, n), np.float32)

        for t in range(T):
            frames = self._frames()
            actions, logps, values = self.act_fn(frames, generator)
            actions = _numpy(actions)
            obs_buf[t] = frames
            act_buf[t] = actions
            logp_buf[t] = _numpy(logps)
            val_buf[t] = _numpy(values)
            for i, env in enumerate(self.envs):
                o, r, d, info = env.step(int(actions[i]))
                rew_buf[t, i] = r
                done_buf[t, i] = float(d)
                self._running[i] += r
                if d:
                    self.ep_returns.append(self._running[i])
                    self._running[i] = 0.0
                    o = env.reset(self._seed)
                    self._seed += 1
                self.obs[i] = o

        # the bootstrap value comes from a fresh draw of the generator
        _, _, last_values = self.act_fn(self._frames(), generator)
        return dict(
            obs=obs_buf, act=act_buf, reward=rew_buf, done=done_buf,
            logp=logp_buf, value=val_buf, last_value=_numpy(last_values),
        ), generator


class Gym3Roller:
    """Segment collector over ONE vectorized gym3 venv (batch act / observe): the port's
    :class:`~arp_tpu_torch.envs.gym3_stub.FakeProcgenGym3` or the C++
    :class:`~arp_tpu_torch.envs.native_engine.NativeProcgenGym3`.  The same segment contract as
    :class:`Roller`: ``done[t]`` marks the step that ended an episode (gym3's ``first`` from the
    observe after the act), and the venv auto-resets."""

    def __init__(self, venv, act_fn: Callable):
        self.venv = venv
        self.act_fn = act_fn
        self.ep_returns: list = []
        self._running = np.zeros(venv.num)
        _, obs, _ = venv.observe()  # initial first=True: fresh episodes, no return to record
        self._rgb = obs["rgb"]

    def _frames(self):
        return np.asarray(self._rgb, np.float32) / 255.0

    def collect(self, generator, T: int):
        n = self.venv.num
        frames0 = self._frames()
        obs_buf = np.zeros((T,) + frames0.shape, np.float32)
        act_buf = np.zeros((T, n), np.int32)
        rew_buf = np.zeros((T, n), np.float32)
        done_buf = np.zeros((T, n), np.float32)
        logp_buf = np.zeros((T, n), np.float32)
        val_buf = np.zeros((T, n), np.float32)

        for t in range(T):
            frames = self._frames()
            actions, logps, values = self.act_fn(frames, generator)
            actions = _numpy(actions)
            obs_buf[t] = frames
            act_buf[t] = actions
            logp_buf[t] = _numpy(logps)
            val_buf[t] = _numpy(values)
            self.venv.act(actions)
            # one observe per act (gym3): rew is this act's reward, first=True that the episode
            # ended and the venv reset
            rew, obs, first = self.venv.observe()
            rew_buf[t] = rew
            done_buf[t] = first.astype(np.float32)
            self._running += rew
            for i in np.nonzero(first)[0]:
                self.ep_returns.append(self._running[i])
                self._running[i] = 0.0
            self._rgb = obs["rgb"]

        _, _, last_values = self.act_fn(self._frames(), generator)
        return dict(
            obs=obs_buf, act=act_buf, reward=rew_buf, done=done_buf,
            logp=logp_buf, value=val_buf, last_value=_numpy(last_values),
        ), generator


def make_adam(config: PPGConfig, n_params: int) -> AdamW:
    """``optax.adam(config.lr)``: AdamW without decay or clipping, at a constant rate."""
    return AdamW(lambda count: config.lr, 0.0, [False] * n_params, None)


def make_ppg_steps(model: PhasicValueModel, config: PPGConfig, sync: Optional[Callable] = None):
    """(ppo_step, aux_step, act, logits_of, pi_step, vf_step, init_phase_opts), as the JAX package's.

    ``sync(grads)``: every minibatch's gradient list passes through it before the update (the
    average over the ranks, under a mesh).

    ``ppo_step(state, batch)`` and ``aux_step(state, batch)`` take a ``parallel/step.py::TrainState``
    over ``model`` (its ``tx`` :func:`make_adam`) and return ``(state, metrics)``;
    ``pi_step(params, opt_state, batch)`` and ``vf_step`` take the state's (name, parameter) list and
    a phase's own ``AdamWState`` and return ``(params, opt_state, metrics)``; the parameters are
    updated in place.  ``act(frames, generator)`` -> (action, logp, value);
    ``logits_of(frames)`` -> logits, ``LOGITS_CHUNK`` frames a forward.  Batches are dicts of tensors
    on the model's device; metrics are 0-dim tensors left there.
    """

    def ppo_losses(batch):
        logits, value, _ = model(batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        logp = logp_all.gather(-1, batch["act"][:, None].long())[:, 0]
        ratio = torch.exp(logp - batch["logp_old"])
        adv = batch["adv"]
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - config.clip_eps, 1 + config.clip_eps) * adv
        pg_loss = -torch.mean(torch.minimum(surr1, surr2))
        vf_loss = 0.5 * torch.mean((value - batch["vtarg"]) ** 2)
        entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, dim=-1))
        return {"pg_loss": pg_loss, "vf_loss": vf_loss, "entropy": entropy}

    def ppo_loss(batch):
        aux = ppo_losses(batch)
        return aux["pg_loss"] + config.vf_coef * aux["vf_loss"] - config.entropy_coef * aux["entropy"], aux

    # Separate pi/vf phases (reference ppo.py:151-152, 221-228): each phase keeps its own persistent
    # optimizer state, so a leaf whose gradient is a structural zero under one phase's loss stays
    # exactly still there.  The reference keeps vfcoef on the vf loss in separate mode (ppo.py:109).
    def pi_only_loss(batch):
        aux = ppo_losses(batch)
        return aux["pg_loss"] - config.entropy_coef * aux["entropy"], aux

    def vf_only_loss(batch):
        aux = ppo_losses(batch)
        return config.vf_coef * aux["vf_loss"], aux

    def aux_loss(batch):
        logits, value, aux_value = model(batch["obs"])
        logp_all = F.log_softmax(logits, dim=-1)
        old_logp_all = F.log_softmax(batch["old_logits"], dim=-1)
        kl = torch.mean(torch.sum(torch.exp(old_logp_all) * (old_logp_all - logp_all), dim=-1))
        aux_vf = 0.5 * torch.mean((aux_value - batch["vtarg"]) ** 2)
        true_vf = 0.5 * torch.mean((value - batch["vtarg"]) ** 2)
        return aux_vf + true_vf + config.beta_clone * kl, {"aux_vf": aux_vf, "true_vf": true_vf, "kl": kl}

    def gradients(loss_fn, params, batch):
        """(grads, metrics): a parameter the loss does not reach gets zeros, as under jax.grad."""
        tensors = [p for _, p in params]
        loss, aux = loss_fn(batch)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(tensors, grads)]
        if sync is not None:
            grads = sync(grads)
        return grads, {k: v.detach() for k, v in dict(aux, loss=loss).items()}

    def ppo_step(state, batch):
        grads, metrics = gradients(ppo_loss, state.params, batch)
        return state.apply_gradients(grads), metrics

    pi_tx = make_adam(config, len(list(model.parameters())))
    vf_tx = make_adam(config, len(list(model.parameters())))

    def pi_step(params, opt_state, batch):
        grads, metrics = gradients(pi_only_loss, params, batch)
        return params, pi_tx.update([p for _, p in params], grads, opt_state), metrics

    def vf_step(params, opt_state, batch):
        grads, metrics = gradients(vf_only_loss, params, batch)
        return params, vf_tx.update([p for _, p in params], grads, opt_state), metrics

    def init_phase_opts(params):
        tensors = [p for _, p in params]
        return pi_tx.init(tensors), vf_tx.init(tensors)

    def aux_step(state, batch):
        grads, metrics = gradients(aux_loss, state.params, batch)
        return state.apply_gradients(grads), metrics

    @torch.no_grad()
    def act(frames, generator):
        logits, value, _ = model(frames)
        action = torch.multinomial(torch.softmax(logits, dim=-1), 1, generator=generator)[:, 0]
        logp = F.log_softmax(logits, dim=-1).gather(-1, action[:, None])[:, 0]
        return action, logp, value

    @torch.no_grad()
    def logits_of(frames):
        return torch.cat([model(frames[i : i + LOGITS_CHUNK])[0] for i in range(0, frames.shape[0], LOGITS_CHUNK)])

    return ppo_step, aux_step, act, logits_of, pi_step, vf_step, init_phase_opts


def act_generator(seed: int, iteration: int, device) -> torch.Generator:
    """The actions' random stream of an iteration: a function of (seed, iteration) alone, so a resumed
    run draws as an uninterrupted one."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + iteration + 1)


def average_over_ranks(tensors: list) -> list:
    """The tensors averaged over every rank: one all-reduce of their concatenation."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat = flat / dist.get_world_size()
    return [piece.view_as(t) for piece, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def _host_opt(opt: AdamWState, names: list) -> dict:
    return {"count": int(opt.count), "mu": {n: m.detach().cpu() for n, m in zip(names, opt.mu)},
            "nu": {n: v.detach().cpu() for n, v in zip(names, opt.nu)}}


def _device_opt(saved: dict, params: list) -> AdamWState:
    return AdamWState(int(saved["count"]), [saved["mu"][n].to(p.device) for n, p in params],
                      [saved["nu"][n].to(p.device) for n, p in params])


class _FramesToDevice:
    """Each step's (N, H, W, C) float32 frames to the device once, through a pinned buffer; the
    copies are kept so the segment's updates index them there."""

    def __init__(self, device: torch.device):
        self.device, self.frames, self._pinned = device, [], None

    def __call__(self, frames: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(frames, np.float32))
        if self.device.type == "cuda":
            if self._pinned is None or self._pinned.shape != host.shape:
                self._pinned = torch.empty(host.shape, dtype=host.dtype).pin_memory()
            # the previous step's copy is done: its actions came back to the host
            host = self._pinned.copy_(host).to(self.device, non_blocking=True)
        self.frames.append(host)
        return host

    def segment(self, T: int) -> torch.Tensor:
        """The first T steps' frames as one (T * N, H, W, C) tensor; the list starts over."""
        seg = torch.stack(self.frames[:T])
        self.frames = []
        return seg.reshape(-1, *seg.shape[2:])


def policy_phase(steps, state, phase_opts, flat: dict, perm_rng, config: PPGConfig, acc: Callable):
    """One iteration's PPO updates on a flat segment (dict of device tensors), minibatches drawn from
    ``perm_rng`` as JAX's ``learn`` draws them; returns (state, phase_opts)."""
    ppo_step, pi_step, vf_step = steps
    n = flat["act"].shape[0]
    device = flat["act"].device

    def minibatches(epochs):
        for _ in range(epochs):
            order = perm_rng.permutation(n)
            for mb in np.array_split(order, config.minibatches):
                idx = torch.from_numpy(mb).to(device)
                yield {k: v.index_select(0, idx) for k, v in flat.items()}

    if phase_opts is None:
        # e_pi == e_vf: one combined objective per epoch (reference ppo.py:151-152, one optimizer)
        for batch in minibatches(config.ppo_epochs):
            state, m = ppo_step(state, batch)
            acc(m)
        return state, None
    # e_pi != e_vf: vf epochs first, then pi, each with its persistent optimizer (ppo.py:221-234)
    pi_opt, vf_opt = phase_opts
    for batch in minibatches(config.vf_epochs):
        _, vf_opt, m = vf_step(state.params, vf_opt, batch)
        acc(m, "vf_")
    for batch in minibatches(config.ppo_epochs):
        _, pi_opt, m = pi_step(state.params, pi_opt, batch)
        acc(m)
    return state, (pi_opt, vf_opt)


def aux_phase(steps, state, seg_buffer: list, perm_rng, config: PPGConfig, acc: Callable):
    """The auxiliary phase over the buffered segments (device tensors); returns the state."""
    aux_step, logits_of = steps
    all_obs = torch.cat([s["obs"] for s in seg_buffer])
    all_vtarg = torch.cat([s["vtarg"] for s in seg_buffer])
    old_logits = logits_of(all_obs)
    m = all_obs.shape[0]
    for _ in range(config.aux_epochs):
        order = perm_rng.permutation(m)
        for mb in np.array_split(order, config.aux_minibatches):
            idx = torch.from_numpy(mb).to(all_obs.device)
            batch = {"obs": all_obs.index_select(0, idx), "vtarg": all_vtarg.index_select(0, idx),
                     "old_logits": old_logits.index_select(0, idx)}
            state, metrics = aux_step(state, batch)
            # "loss" would collide with the ppo / pi phase's loss key
            acc({("aux_loss" if k == "loss" else k): v for k, v in metrics.items()})
    return state


def learn(
    env_fn: Callable,
    config: PPGConfig = PPGConfig(),
    total_iterations: int = 8,
    seed: int = 0,
    logger=None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    save_every: int = 0,
    venv_fn: Optional[Callable] = None,
    device="cuda",
):
    """Run PPG on ``device``; returns (train state, metrics history), the history's records with the
    JAX package's keys.

    ``venv_fn(seed) -> gym3 venv`` (``num == config.num_envs``): collect with :class:`Gym3Roller`
    over one vectorized venv instead of :class:`Roller` over ``env_fn()`` envs.  ``checkpoint_dir`` +
    ``save_every``: a ``step_<it>.pt`` every ``save_every`` iterations and at the last, and an
    automatic resume from the newest.  ``mesh``: the data mesh of several processes (the module's
    docstring); it needs the process group it was built in.
    """
    import torch.distributed as dist

    from ..checkpoint import CheckpointManager

    if mesh is not None and not dist.is_initialized():
        raise RuntimeError("learn(mesh): the mesh needs the process group it was built in "
                           "(parallel/distributed.py::initialize)")
    multiproc = mesh is not None and dist.get_world_size() > 1
    # per-rank env exploration: the ENV seeds are offset by rank; the params keep the shared seed
    env_seed = seed + (dist.get_rank() * 100003 if multiproc else 0)
    assert not (multiproc and checkpoint_dir), (
        "multi-process PPG checkpointing is not coordinated yet — run saves from a single-process job")
    device = resolve_device(device)
    venv = None
    if venv_fn is not None:
        venv = venv_fn(env_seed)
        if venv.num != config.num_envs:
            raise ValueError(f"the venv has {venv.num} envs, the config {config.num_envs}")
        frame_shape = venv.observe()[1]["rgb"].shape[1:]
    else:
        envs = [env_fn() for _ in range(config.num_envs)]
        key = envs[0].config.image_key.split(", ")[0]
        probe = envs[0].reset(env_seed)
        frame_shape = np.asarray(probe["image"][key]).shape
    model = PhasicValueModel(num_actions=15, arch=config.arch, frame_shape=tuple(frame_shape),
                             generator=torch.Generator().manual_seed(seed)).to(device)
    if multiproc:
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p, src=0)
    state = TrainState.create(model, make_adam(config, len(list(model.parameters()))))
    names = [n for n, _ in state.params]

    ppo_step, aux_step, act, logits_of, pi_step, vf_step, init_phase_opts = make_ppg_steps(
        model, config, sync=average_over_ranks if multiproc else None)
    separate_phases = config.ppo_epochs != config.vf_epochs
    phase_opts = init_phase_opts(state.params) if separate_phases else None

    start_it, history, restored_normalizer, mngr = 0, [], None, None
    if checkpoint_dir:
        mngr = CheckpointManager(checkpoint_dir)
        if mngr.latest_step() is not None:
            state, meta = mngr.restore(state)
            if separate_phases:
                phase_opts = tuple(_device_opt(meta["phase_opts"][k], state.params) for k in ("pi", "vf"))
            if config.reward_norm and "normalizer" in meta:
                restored_normalizer = {k: v.numpy() for k, v in meta["normalizer"].items()}
            start_it = int(meta["iteration"]) + 1
            history = list(meta["history"])

    normalizer = RewardNormalizer(config.num_envs, gamma=config.gamma) if config.reward_norm else None
    if normalizer is not None and restored_normalizer is not None:
        normalizer.load_state_dict(restored_normalizer)

    def _save(it):
        metadata = {"iteration": it, "history": history}
        if separate_phases:
            metadata["phase_opts"] = {"pi": _host_opt(phase_opts[0], names), "vf": _host_opt(phase_opts[1], names)}
        if normalizer is not None:
            metadata["normalizer"] = {k: torch.as_tensor(np.asarray(v, np.float64))
                                      for k, v in normalizer.state_dict().items()}
        mngr.save(it, state, metadata=metadata)

    to_device = _FramesToDevice(device)

    def act_fn(frames, generator):
        return act(to_device(frames), generator)

    roller = Gym3Roller(venv, act_fn) if venv is not None else Roller(envs, act_fn, seed=env_seed)
    seg_buffer = []
    for it in range(start_it, total_iterations):
        seg, _ = roller.collect(act_generator(env_seed, it, device), config.segment_length)
        obs = to_device.segment(config.segment_length)
        if normalizer is not None:
            seg["reward"] = normalizer.normalize_segment(seg["reward"], seg["done"])
        adv, vtarg = compute_gae(
            seg["reward"], seg["value"], seg["done"], seg["last_value"], gamma=config.gamma, lam=config.lam,
        )
        adv = (adv - adv.mean()) / (adv.std() + 1e-8)
        flat = {
            "obs": obs,
            "act": torch.from_numpy(seg["act"].reshape(-1).astype(np.int64)).to(device),
            "logp_old": torch.from_numpy(seg["logp"].reshape(-1)).to(device),
            "adv": torch.from_numpy(adv.reshape(-1).astype(np.float32)).to(device),
            "vtarg": torch.from_numpy(vtarg.reshape(-1).astype(np.float32)).to(device),
        }
        # per-phase metric accumulation: a record holds the mean over every minibatch of the iteration
        acc: dict = {}

        def _acc(m, prefix=""):
            for k, v in m.items():
                acc.setdefault(prefix + k, []).append(v)

        perm_rng = np.random.default_rng(seed + it)
        state, phase_opts = policy_phase((ppo_step, pi_step, vf_step), state, phase_opts, flat, perm_rng, config,
                                         _acc)
        seg_buffer.append({"obs": flat["obs"], "vtarg": flat["vtarg"]})
        if (it + 1) % config.n_pi == 0 and config.aux_epochs > 0:
            state = aux_phase((aux_step, logits_of), state, seg_buffer, perm_rng, config, _acc)
            seg_buffer = []

        ep_ret = float(np.mean(roller.ep_returns[-20:])) if roller.ep_returns else 0.0
        record = {k: float(np.mean(torch.stack(v).float().cpu().numpy())) for k, v in acc.items()}
        if multiproc:  # the global batch's values, as JAX's records hold
            mean = average_over_ranks([torch.tensor(list(record.values()), dtype=torch.float64, device=device)])[0]
            record = dict(zip(record, mean.tolist()))
        record.update(iteration=it, mean_episode_return=ep_ret)
        history.append(record)
        if logger is not None:
            logger.log(record)
        if mngr is not None and ((save_every and (it + 1) % save_every == 0) or it + 1 == total_iterations):
            _save(it)
    return state, history
