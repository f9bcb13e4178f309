"""Reproduce the paper's Procgen benchmark table (train -> eval -> results) with the port's CLIs.

The port of the JAX package's ``scripts/reproduce_paper.py``.  The reference defines its benchmark
as five train/test environment splits (reference README.md:36-43; BASELINE.md "Benchmark task
definitions") and an eval protocol of 100 episodes at episode length 500 (reference
jobs/eval_procgen.sh:36-38).  This driver runs that matrix end to end with
``python -m arp_tpu_torch.train.main`` and ``arp_tpu_torch.train.eval`` and writes one results
table (``results.json``, and markdown on stdout):

    ARP_TPU_CHECKPOINT_DIR=/path/to/m3ae_ckpts python -m arp_tpu_torch.drivers.reproduce_paper \\
        --data_path ./demonstrations --output ./paper_results --seeds 42,43,44 -- --mesh_fsdp=4

The commands carry the JAX script's flags, plus ``--device`` (``--device``: cuda unless cpu is
asked for).  Everything after ``--`` goes to the trainer verbatim (the port's ``--mesh_*`` and
other trainer-only flags; the eval CLI takes none of them).  Pretrained encoder weights resolve as
the trainer's do: the M3AE pickles through ``ARP_TPU_CHECKPOINT_DIR``, CLIP through
``--model.clip_checkpoint_path``.  Tasks that share a training split (CoinRun and CoinRun-bluegem
both train on coinrun/none) train once a seed and share the checkpoint.

``--smoke`` runs the same orchestration on its own: demos are collected from the fake env with a
scripted expert, labeled with a tiny random-init CLIP and trained / evaluated with the debug-size
policy, in minutes, with no external files.  With ``--device cpu`` it needs no card.  The children
run with ``PYTHONPATH`` set to the repository and the JAX package's environment variables dropped.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_JAX_VARIABLE_PREFIXES = ("JAX_", "XLA_", "TPU_", "LIBTPU")

# Reference README.md:36-43: the five paper tasks.
PAPER_TASKS = {
    "coinrun": dict(game="coinrun", train_env="none", eval_env="aisc"),
    "coinrun-bluegem": dict(game="coinrun", train_env="none", eval_env="aisc_gem"),
    "maze1": dict(game="maze", train_env="aisc", eval_env="none"),
    "maze2": dict(game="maze", train_env="yellowline", eval_env="redline"),
    "maze3": dict(game="maze", train_env="redline_yellowgem", eval_env="reddiag_redstraight_yellowgem"),
}

# Reference jobs/train_procgen.sh:31-47 defaults (the paper's training config).
FULL_TRAIN = dict(
    epochs=50, batch_size=128, lr="5e-4", num_frames=8, window_size=4,
    model_type="vit_base", transfer_type="m3ae_vit_b16", num_demonstrations=500,
    num_levels=500, episode_length=500, eval_env="procgen",
)
SMOKE_TRAIN = dict(
    epochs=2, batch_size=8, lr="1e-3", num_frames=8, window_size=4,
    model_type="vit_debug", transfer_type="none", num_demonstrations=4,
    num_levels=500, image_size=32, episode_length=6, eval_env="fake",
)


def child_env(smoke: bool) -> dict:
    """The children's environment: ``PYTHONPATH`` the repository (in front of the caller's outside the
    smoke run), the JAX package's variables dropped; the smoke run registers the tiny CLIP config."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(_JAX_VARIABLE_PREFIXES)}
    if smoke:
        env["PYTHONPATH"] = REPO_ROOT
        env.setdefault("ARP_TPU_TINY_CLIP", "1")
    else:
        env["PYTHONPATH"] = os.pathsep.join([REPO_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def train_cmd(task, seed, cfg, data_path, ckpt_dir, out_dir, extra, device="cuda"):
    tiny = cfg["model_type"] == "vit_debug"
    cmd = [
        sys.executable, "-m", "arp_tpu_torch.train.main",
        f"--seed={seed}",
        f"--epochs={cfg['epochs']}",
        f"--batch_size={cfg['batch_size']}",
        f"--lr={cfg['lr']}",
        "--lr_schedule=cos", "--weight_decay=5e-5", "--clip_gradient=10.0",
        f"--window_size={cfg['window_size']}",
        f"--game_name={task['game']}",
        "--use_vl=True", "--vl_type=clip",
        f"--episode_length={cfg['episode_length']}",
        f"--eval_env={cfg['eval_env']}",
        f"--env_eval_env_type={task['eval_env']}",
        f"--env_num_levels={cfg['num_levels']}",
        f"--model.model_type={cfg['model_type']}",
        f"--model.transfer_type={cfg['transfer_type']}",
        f"--data.path={data_path}",
        f"--data.num_demonstrations={cfg['num_demonstrations']}",
        f"--data.num_frames={cfg['num_frames']}",
        f"--data.window_size={cfg['window_size']}",
        f"--data.train_env_type={task['train_env']}",
        "--data.use_vl=True", "--data.vl_type=clip",
        f"--checkpoint_dir={ckpt_dir}",
        f"--logging.output_dir={out_dir}",
    ]
    if tiny:
        cmd += [
            "--warmup_epochs=0", "--dataloader_n_workers=0", "--use_crop=False",
            # test_every_epochs also drives the checkpoint's save frequency: keep it > 0 so that
            # a checkpoint lands for the eval stage
            "--val_every_epochs=0", "--test_every_epochs=1", "--num_test_episodes=1",
            "--model.emb_dim=32", "--model.depth=2", "--model.num_heads=4",
            "--model.mlp_ratio=2", "--model.num_ensembles=2",
            f"--data.image_size={cfg['image_size']}",
        ]
    else:
        cmd += [
            "--val_every_epochs=10", "--test_every_epochs=20",
            "--num_test_episodes=10", "--model.use_adapter=True",
            "--env_distribution_mode=hard", "--env_start_level=0",
        ]
    return cmd + [f"--device={device}"] + extra


def eval_cmd(task, seed, cfg, data_path, ckpt_dir, out_dir, episodes, device="cuda"):
    tiny = cfg["model_type"] == "vit_debug"
    cmd = [
        sys.executable, "-m", "arp_tpu_torch.train.eval",
        f"--seed={seed}",
        f"--checkpoint_dir={ckpt_dir}",
        f"--num_test_episodes={episodes}",
        f"--episode_length={cfg['episode_length']}",
        "--use_vl=True", "--vl_type=clip",
        f"--game_name={task['game']}",
        f"--eval_env={cfg['eval_env']}",
        f"--env_eval_env_type={task['eval_env']}",
        f"--window_size={cfg['window_size']}",
        f"--model.model_type={cfg['model_type']}",
        f"--model.transfer_type={cfg['transfer_type']}",
        f"--data.path={data_path}",
        f"--data.num_demonstrations={cfg['num_demonstrations']}",
        f"--data.num_frames={cfg['num_frames']}",
        f"--data.window_size={cfg['window_size']}",
        f"--data.train_env_type={task['train_env']}",
        "--data.use_vl=True", "--data.vl_type=clip",
        f"--logging.output_dir={out_dir}",
    ]
    if tiny:
        cmd += [
            "--use_crop=False",
            "--model.emb_dim=32", "--model.depth=2", "--model.num_heads=4",
            "--model.mlp_ratio=2", "--model.num_ensembles=2",
            f"--data.image_size={cfg['image_size']}",
        ]
    else:
        # mirrors train_cmd: use_adapter changes the policy's parameters, and the eval CLI builds the
        # model it restores into from its own flags
        cmd += ["--model.use_adapter=True"]
    # the post-'--' extras are trainer-only flags: the eval CLI defines none of them
    return cmd + [f"--device={device}"]


def run(cmd, env, log_path, dry_run=False):
    if dry_run:
        print(" ".join(cmd))
        return
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"command failed (rc={proc.returncode}): {' '.join(cmd)}\n{tail}")


def parse_eval_metrics(log_path):
    """The eval CLI prints the metric dict as its last stdout line (train/eval.py)."""
    with open(log_path) as f:
        lines = [line for line in f.read().splitlines() if line.startswith("{")]
    if not lines:
        raise RuntimeError(f"no metric line in {log_path}")
    return ast.literal_eval(lines[-1])


def smoke_prep(data_root, game, train_env, device="cuda"):
    """Collect and label tiny demos for one training split (fake env, scripted expert, tiny random
    CLIP on ``device``): the smoke run's stand-in for the reference's demonstration download and
    label_reward stages."""
    from ..collect.recorder import collect_demonstrations
    from ..data.instructions import get_clip_instruct
    from ..data.procgen_dataset import dataset_dirname
    from ..envs.fake import FakeProcgen
    from ..reward.labeler import label_rewards
    from ..testing import TINY_CLIP_IMG_SIZE, make_tiny_clip_engine, scripted_coin_expert

    dirname = dataset_dirname(game, num_demonstrations=4, num_frames=8, env_type=train_env)
    dest = os.path.join(data_root, dirname)
    os.makedirs(dest, exist_ok=True)
    for split, n_eps, seed in (("train", 4, 0), ("val", 2, 100)):
        env = FakeProcgen(game, {"episode_length": 30, "image_size": TINY_CLIP_IMG_SIZE, "grid": 4})
        collect_demonstrations(env, scripted_coin_expert, os.path.join(dest, f"data_{split}.hdf5"),
                               num_episodes=n_eps, game_name=game, num_frames=8, seed=seed)
    engine = make_tiny_clip_engine(batch_size=8, device=device)
    env_name = game if train_env == "none" else f"{game}_{train_env}"
    text = get_clip_instruct(env_name)
    for split in ("train", "val"):
        label_rewards(os.path.join(dest, f"data_{split}.hdf5"), text, engine=engine, progress=False)
    print(f"[prep] {dest}: collected + labeled ({text!r})")


def results_markdown(results) -> str:
    lines = ["| Task | Train | Test | Success rate | Return | Seeds |", "|---|---|---|---|---|---|"]
    for name, res in results.items():
        lines.append(f"| {name} | {res['train']} | {res['test']} | "
                     f"{res['success_rate_mean']:.3f} | {res['return_mean']:.2f} | {len(res['seeds'])} |")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tasks", default=",".join(PAPER_TASKS), help=f"comma list from: {', '.join(PAPER_TASKS)}")
    parser.add_argument("--seeds", default="42", help="comma list of training seeds")
    parser.add_argument("--data_path", default="./demonstrations",
                        help="labeled-demonstrations root (reference README stage 1-3)")
    parser.add_argument("--output", default="./paper_results")
    parser.add_argument("--eval_episodes", type=int, default=100,
                        help="paper protocol: 100 (reference jobs/eval_procgen.sh:36-38)")
    parser.add_argument("--smoke", action="store_true", help="self-contained tiny run (fake env)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where every CLI runs (cuda unless cpu is asked for)")
    parser.add_argument("--skip_train", action="store_true", help="eval existing checkpoints under --output only")
    parser.add_argument("--dry_run", action="store_true", help="print every command instead of running it")
    parser.add_argument("--_smoke_prep", nargs=3, metavar=("DATA_ROOT", "GAME", "TRAIN_ENV"), help=argparse.SUPPRESS)
    args, extra = parser.parse_known_args(argv)
    if extra and extra[0] == "--":
        extra = extra[1:]

    if args._smoke_prep:
        smoke_prep(*args._smoke_prep, device=args.device)
        return

    cfg = SMOKE_TRAIN if args.smoke else FULL_TRAIN
    env = child_env(args.smoke)
    if args.smoke:
        args.eval_episodes = min(args.eval_episodes, 2)

    out_root = os.path.abspath(args.output)
    os.makedirs(out_root, exist_ok=True)
    data_path = os.path.join(out_root, "demos") if args.smoke else os.path.abspath(args.data_path)

    tasks = {}
    for name in args.tasks.split(","):
        name = name.strip()
        if name not in PAPER_TASKS:
            parser.error(f"unknown task {name!r}; choose from {', '.join(PAPER_TASKS)}")
        tasks[name] = PAPER_TASKS[name]
    seeds = [int(s) for s in args.seeds.split(",")]

    if args.smoke:
        prepped = set()
        for task in tasks.values():
            split = (task["game"], task["train_env"])
            if split in prepped:
                continue
            prepped.add(split)
            run([sys.executable, "-m", "arp_tpu_torch.drivers.reproduce_paper", "--_smoke_prep", data_path,
                 task["game"], task["train_env"], f"--device={args.device}"],
                env, os.path.join(out_root, f"prep_{task['game']}_{task['train_env']}.log"), dry_run=args.dry_run)

    results = {}
    trained = {}  # (game, train_env, seed) -> checkpoint dir
    for name, task in tasks.items():
        results[name] = {"train": f"{task['game']}/{task['train_env']}",
                         "test": f"{task['game']}/{task['eval_env']}", "seeds": {}}
        for seed in seeds:
            split = (task["game"], task["train_env"], seed)
            ckpt_dir = os.path.join(out_root, "ckpt_" + "_".join(map(str, split)))
            if split not in trained:
                if not args.skip_train:
                    print(f"[train] {split[0]}/{split[1]} seed={seed}", flush=True)
                    run(train_cmd(task, seed, cfg, data_path, ckpt_dir, os.path.join(out_root, "logs"), extra,
                                  args.device),
                        env, os.path.join(out_root, f"train_{'_'.join(map(str, split))}.log"), dry_run=args.dry_run)
                trained[split] = ckpt_dir
            log = os.path.join(out_root, f"eval_{name}_seed{seed}.log")
            print(f"[eval]  {name} seed={seed} ({task['game']}/{task['eval_env']})", flush=True)
            run(eval_cmd(task, seed, cfg, data_path, trained[split], os.path.join(out_root, "logs"),
                         args.eval_episodes, args.device),
                env, log, dry_run=args.dry_run)
            if args.dry_run:
                continue
            results[name]["seeds"][str(seed)] = parse_eval_metrics(log)

    if args.dry_run:
        return

    for res in results.values():
        vals = [m.get("success_rate", float("nan")) for m in res["seeds"].values()]
        rets = [m.get("return", float("nan")) for m in res["seeds"].values()]
        res["success_rate_mean"] = sum(vals) / len(vals)
        res["return_mean"] = sum(rets) / len(rets)

    with open(os.path.join(out_root, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    print("\n" + results_markdown(results))
    print(f"\nresults written to {os.path.join(out_root, 'results.json')}")


if __name__ == "__main__":
    main()
