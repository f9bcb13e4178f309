"""PPG expert training CLI: ``python -m arp_tpu_torch.collect.train_ppg`` (port of arp_tpu/collect/train_ppg.py).

The reference's ``python -m phasic_policy_gradient.train`` on one GPU, or on N with
``torchrun --nproc_per_node=N -m arp_tpu_torch.collect.train_ppg --mesh_dp=N``: ``--mesh_dp`` above 1
is the world of torchrun's processes (JAX's is that many local devices), each rank rolling its own
``--num_envs`` envs (collect/ppg.py::learn); rank 0 logs and writes ``--checkpoint_path``.  The flags
are the JAX CLI's, under argparse, parsed as ``train/main.py`` parses its own (``--fake_env=True``,
``--logging.output_dir=...``, ``--x=v`` or ``--x v``), plus ``--device`` (cuda unless cpu is asked for).  ``--vec_env`` "" steps
per-env wrappers (``envs/fake.py`` under ``--fake_env``, else ``envs/procgen.py``); "python" and
"native" one vectorized gym3 venv (``envs/gym3_stub.py``, the C++ ``envs/native_engine.py``).
``--checkpoint_path`` writes ``{"params": <the Flax-layout tree, numpy>, "history": [...]}`` with
``checkpoint.py::save_pickle``, which the JAX package's ``eval_ppg`` and ``collect`` read, as the
port's do.  ``--checkpoint_dir`` / ``--save_every``: ``collect/ppg.py::learn``'s checkpoints and resume
(one process only, as in JAX).
"""

from __future__ import annotations

from ..checkpoint import save_pickle
from ..config import Config, flag_leaves, parse_flag_tree
from ..device import resolve_device
from ..logging_utils import MetricsLogger
from ..parallel.distributed import initialize
from ..parallel.mesh import MeshConfig, create_mesh
from .convert_ppg import torch_ppg_to_flax
from .ppg import PPGConfig, learn


def flag_defaults() -> dict:
    """The JAX CLI's flags and defaults, and ``device``."""
    return dict(
        seed=42, game_name="coinrun", num_envs=8, segment_length=256, total_iterations=1000, n_epoch_pi=1,
        n_epoch_vf=1, reward_norm=True, n_aux_epochs=6, n_pi=32, lr=5e-4, clip_eps=0.2, entropy_coef=0.01,
        gamma=0.999, lam=0.95, beta_clone=1.0, arch="dual", fake_env=False,
        # "" = per-env Python wrappers; "python" / "native" = ONE vectorized gym3 venv (Gym3Roller)
        vec_env="", episode_length=1000, checkpoint_path="", mesh_dp=0, checkpoint_dir="", save_every=0,
        logging=MetricsLogger.get_default_config(), device="cuda",
    )


def parse_flags(argv=None) -> Config:
    return parse_flag_tree(flag_defaults(), argv, "Train a PPG expert (PyTorch, one GPU or several).")


def ppg_config(flags) -> PPGConfig:
    """The PPGConfig the flags ask for, as the JAX CLI builds it."""
    return PPGConfig(
        num_envs=flags.num_envs, segment_length=flags.segment_length, gamma=flags.gamma, lam=flags.lam,
        clip_eps=flags.clip_eps, entropy_coef=flags.entropy_coef, lr=flags.lr, ppo_epochs=flags.n_epoch_pi,
        vf_epochs=flags.n_epoch_vf, reward_norm=flags.reward_norm, n_pi=flags.n_pi, aux_epochs=flags.n_aux_epochs,
        beta_clone=flags.beta_clone, arch=flags.arch,
    )


def env_fns(flags):
    """(env_fn, venv_fn) for ``learn``: one of them is used, as the flags choose."""
    if flags.vec_env:
        if flags.vec_env == "native":
            from ..envs.native_engine import NativeProcgenGym3 as cls
        elif flags.vec_env == "python":
            from ..envs.gym3_stub import FakeProcgenGym3 as cls
        else:
            raise ValueError(f"--vec_env must be python|native, got {flags.vec_env!r}")

        def venv_fn(seed):
            return cls(game_name=flags.game_name, num=flags.num_envs, resolution=64,
                       episode_length=flags.episode_length, rand_seed=seed)

        def env_fn():
            raise AssertionError("unused with --vec_env")

        return env_fn, venv_fn
    if flags.fake_env:
        from ..envs.fake import FakeProcgen

        return (lambda: FakeProcgen(flags.game_name, {"episode_length": flags.episode_length})), None
    from ..envs.procgen import Procgen

    return (lambda: Procgen(flags.game_name, {"episode_length": flags.episode_length, "use_train_levels": True},
                            image_resolution="low")), None


def main(argv=None):
    flags = parse_flags(argv)
    process_index = 0
    mesh = None
    if flags.mesh_dp > 1:
        process_index, _ = initialize(device=flags.device)
        mesh = create_mesh(MeshConfig(dp=flags.mesh_dp), flags.device)
    device = resolve_device(flags.device)
    logger = MetricsLogger(config=flags.logging, variant=dict(flag_leaves(flags)), enable=process_index == 0)
    env_fn, venv_fn = env_fns(flags)
    state, history = learn(
        env_fn, ppg_config(flags), total_iterations=flags.total_iterations, seed=flags.seed, logger=logger,
        mesh=mesh, checkpoint_dir=flags.checkpoint_dir or None, save_every=flags.save_every, venv_fn=venv_fn,
        device=device,
    )
    if flags.checkpoint_path and process_index == 0:
        save_pickle({"params": torch_ppg_to_flax(state.model.state_dict()), "history": history},
                    flags.checkpoint_path)
    logger.close()
    return state, history


if __name__ == "__main__":
    main()
