"""The PyTorch port imports no JAX: every arp_tpu_torch module (the policy, its server and
chip_smoke.py too) loads with jax, flax, ml_collections, orbax, optax and arp_tpu blocked.  Nor
does it read the JAX package's files: no code of the port names a path under ``arp_tpu/``, and the
eval path (envs, the native engine's build, rollouts, videos), the reward server and the labeler's
shard path (the ARPS reader's and the host resize's builds, several hosts, the merge) open, load and
compile nothing there."""

import ast
import os
import re
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    BLOCKED = ("jax", "jaxlib", "flax", "ml_collections", "orbax", "optax", "arp_tpu")

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import arp_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(arp_tpu_torch.__path__, "arp_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    print("IMPORTED", len(names), " ".join(names))
    """
)


def test_port_imports_without_jax_or_flax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr + out.stdout
    n, *names = out.stdout.split("IMPORTED")[1].split()
    assert int(n) >= 81, out.stdout  # every module of the package, not an empty walk
    for module in ("serve", "config", "utils", "models.layers", "models.m3ae", "models.impala", "models.policy.models",
                   "models.policy.convert", "ops.m3ae_infer", "ops.augment", "train.main", "train.common",
                   "parallel.step", "parallel.prefetch", "data.procgen_dataset", "data.loader", "data.validate",
                   "data.instructions", "checkpoint", "logging_utils", "profiling", "resilience", "models.clip.model",
                   "models.clip.convert", "finetune", "finetune.adapter_model", "finetune.convert", "finetune.dataset",
                   "finetune.decoder", "finetune.train", "finetune.reward", "envs", "envs.fake", "envs.state_codec",
                   "envs.gym3_stub", "envs.native_engine", "envs.procgen", "envs.rollout", "train.eval", "video",
                   "native", "data.arps", "data.cache_embeddings", "reward.serve", "_pickle_compat", "ops.flop_count",
                   "collect", "collect.recorder", "collect.fuse", "collect.downsize", "collect.reward_normalizer",
                   "testing", "collect.ppg", "collect.convert_ppg", "collect.train_ppg", "collect.eval_ppg",
                   "collect.collect", "models.resnet", "train.pretrain_m3ae", "parallel", "parallel.distributed",
                   "parallel.mesh", "parallel.pipeline", "parallel.tensor_parallel"):
        assert f"arp_tpu_torch.{module}" in names, module


def test_chip_smoke_imports_without_jax_or_the_jax_package():
    script = _SCRIPT.replace(
        "import arp_tpu_torch\n", "import chip_smoke, arp_tpu_torch\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr + out.stdout


def test_port_names_no_library_kernel():
    """The library yardsticks live in chip_smoke.py alone: no file of the port names one."""
    banned = ("scaled_dot_product_attention", "_int_mm", "torch.compile")
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "arp_tpu_torch")):
        if "__pycache__" in root:
            continue
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh", ".md")):
                continue
            with open(os.path.join(root, name), encoding="utf-8") as f:
                text = f.read()
            hits += [(os.path.join(root, name), word) for word in banned if word in text]
    assert not hits, hits


def test_policy_and_server_run_without_jax_or_the_jax_package():
    """Not only imports: a policy forward and a server action with the JAX stack blocked."""
    script = _SCRIPT + textwrap.dedent(
        """
        import numpy as np, torch
        from arp_tpu_torch.models.policy import ARPDT
        from arp_tpu_torch.serve import PolicyServer
        model = ARPDT(dict(model_type="vit_debug", emb_dim=32, depth=1, num_heads=4, use_discrete_action=True),
                      num_actions=15, patch_dim=16).eval()
        server = PolicyServer(policy_fn=lambda i: model.greedy_action(i), transform_obs_fn=lambda x: x / 255.0)
        sid = server.create_session({})["session_id"]
        with torch.no_grad():
            out = server.act({"session_id": sid, "observation": np.zeros((32, 32, 3), np.uint8).tolist()})
        assert 0 <= out["action"] < 15
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_train_step_runs_without_jax_or_the_jax_package():
    """The train step's modules (no h5py needed) and one step with the JAX stack blocked."""
    script = _SCRIPT + textwrap.dedent(
        """
        import numpy as np, torch
        from arp_tpu_torch.config import Config
        from arp_tpu_torch.models.policy import ARPDT
        from arp_tpu_torch.ops.augment import make_augment_fn
        from arp_tpu_torch.parallel.step import TrainState, make_train_step
        from arp_tpu_torch.train import common
        sys.modules.pop("h5py", None)
        model = ARPDT(dict(model_type="vit_debug", emb_dim=32, depth=1, num_heads=4, use_discrete_action=True),
                      num_actions=15, patch_dim=16)
        rng = np.random.default_rng(0)
        batch = {"image": {"ob": rng.integers(0, 256, size=(2, 2, 32, 32, 3), dtype=np.uint8)},
                 "rtg": {"ob": np.ones((2, 2, 1), np.float32)}, "action": np.zeros((2, 2), np.int32),
                 "instruct": None, "text_padding_mask": None}
        with torch.no_grad():
            model(batch, deterministic=True)
        flags = Config(clip_gradient=10.0, weight_decay=5e-5)
        state = TrainState.create(model, common.build_optimizer(flags, lambda c: 1e-3, model))
        step = make_train_step(common.make_loss_fn(model, make_augment_fn("random_crop,color_jitter", 32, 32), 32, False))
        state, aux = step(state, batch, torch.Generator().manual_seed(0))
        assert np.isfinite(float(aux["loss"])) and state.step == 1
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED + ("h5py",))
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def _docstring_nodes(tree) -> set:
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant) and isinstance(first.value.value, str):
                ids.add(id(first.value))
    return ids


def test_port_names_no_path_into_the_jax_package():
    """No string of the port's code (docstrings aside: they say what a module ports) is the JAX package's
    directory or a path in it, and no C++ / CUDA source includes or names one in a string (the port keeps
    its own copies, native/gridenv.cpp among them)."""
    into_jax = re.compile(r"(?<![\\w.])arp_tpu[/\\]")
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "arp_tpu_torch")):
        if "__pycache__" in root:
            continue
        for name in files:
            path = os.path.join(root, name)
            if name.endswith(".py"):
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read())
                docs = _docstring_nodes(tree)
                hits += [(path, node.lineno, node.value) for node in ast.walk(tree)
                         if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs
                         and (node.value == "arp_tpu" or into_jax.search(node.value))]
            elif name.endswith((".cpp", ".cu", ".cuh", ".sh")):
                with open(path, encoding="utf-8") as f:
                    hits += [(path, i, line.strip()) for i, line in enumerate(f, 1)
                             if into_jax.search(line) and (line.lstrip().startswith("#include") or '"' in line)]
    assert not hits, hits


def test_eval_path_reads_nothing_of_the_jax_package(tmp_path):
    """With the JAX stack blocked and an audit hook on every open, library load and process start: the
    native engine builds from the port's own source, the envs step, both rollouts run with a policy and a
    reward engine, a video is written; nothing under arp_tpu/ is touched."""
    script = _SCRIPT + textwrap.dedent(
        f"""
        import os, numpy as np, torch
        JAX_DIR = os.path.join({REPO!r}, "arp_tpu") + os.sep
        touched = []

        def audit(event, args):
            if event in ("open", "ctypes.dlopen", "subprocess.Popen", "os.listdir", "os.scandir"):
                for a in args:
                    items = a if isinstance(a, (list, tuple)) else [a]
                    for x in items:
                        if isinstance(x, (str, bytes, os.PathLike)):
                            p = os.path.realpath(os.fsdecode(x))
                            if p.startswith(JAX_DIR):
                                touched.append((event, p))

        sys.addaudithook(audit)
        os.environ["ARP_TPU_FAKE_ENGINE"] = "native"
        from arp_tpu_torch.envs import FakeProcgen, Procgen
        from arp_tpu_torch.envs.native_engine import native_lib
        from arp_tpu_torch.envs.rollout import batch_rollout, parallel_rollout
        from arp_tpu_torch.models.clip import CLIP
        from arp_tpu_torch.models.policy import ARPDT
        from arp_tpu_torch.ops.augment import make_eval_transform
        from arp_tpu_torch.reward.engine import ClipRewardEngine
        from arp_tpu_torch.video import save_video
        native_lib()
        env = Procgen("coinrun", {{"episode_length": 4}}, image_resolution="low")
        env.reset(1)
        env.set_state(env.get_state())
        model = ARPDT(dict(model_type="vit_debug", emb_dim=32, depth=1, num_heads=4, use_discrete_action=True),
                      num_actions=15, patch_dim=16).eval()
        engine = ClipRewardEngine(model=CLIP(embed_dim=16, vocab_size=49408, vision_num_layers=1, vision_features=64,
                                             vision_patch_size=16, text_features=16, text_num_heads=4,
                                             text_num_layers=1, image_size=32), batch_size=4, device="cpu")
        policy = lambda inputs, rngs: model.greedy_action(inputs)
        conf = {{"episode_length": 3, "image_size": 32, "grid": 4}}
        kw = dict(transform_obs_fn=make_eval_transform(32, device="cpu"), episode_length=3, window_size=2,
                  reward_engine=engine, text="collect the coin.", device="cpu")
        with torch.no_grad():
            metric, _, videos = batch_rollout(0, 0, FakeProcgen("coinrun", conf), policy, **kw)
            parallel_rollout(0, [FakeProcgen("coinrun", conf) for _ in range(2)], policy, **kw)
        save_video(videos[0], os.path.join({str(tmp_path)!r}, "v.mp4"))
        assert np.isfinite(metric["return"])
        assert not touched, touched
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_server_and_shard_path_read_nothing_of_the_jax_package(tmp_path):
    """With the JAX stack blocked and the audit hook of the eval path's test: the reward server answers a raw
    request over a host-resize engine (its library built from the port's source), a file is labeled by two
    hosts and merged, its frames converted to ARPS shards and read back natively, and the embedding cache
    written; nothing under arp_tpu/ is opened, loaded or compiled."""
    script = _SCRIPT + textwrap.dedent(
        f"""
        import os, numpy as np, h5py, torch
        JAX_DIR = os.path.join({REPO!r}, "arp_tpu") + os.sep
        touched = []

        def audit(event, args):
            if event in ("open", "ctypes.dlopen", "subprocess.Popen", "os.listdir", "os.scandir"):
                for a in args:
                    items = a if isinstance(a, (list, tuple)) else [a]
                    for x in items:
                        if isinstance(x, (str, bytes, os.PathLike)):
                            p = os.path.realpath(os.fsdecode(x))
                            if p.startswith(JAX_DIR):
                                touched.append((event, p))

        sys.addaudithook(audit)
        from arp_tpu_torch.data.arps import ArpsReader, convert_hdf5
        from arp_tpu_torch.data.cache_embeddings import cache_clip_embeddings
        from arp_tpu_torch.models.clip import CLIP
        from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
        from arp_tpu_torch.reward.engine import ClipRewardEngine
        from arp_tpu_torch.reward.labeler import label_rewards, merge_reward_shards
        from arp_tpu_torch.reward.serve import RewardServer
        tmp = {str(tmp_path)!r}
        engine = ClipRewardEngine(model=CLIP(embed_dim=16, vocab_size=97, vision_num_layers=1, vision_features=64,
                                             vision_patch_size=16, text_features=16, text_num_heads=4,
                                             text_num_layers=1, image_size=32),
                                  batch_size=4, device="cpu", resize_mode="host", tokenizer=Char97Tokenizer())
        frames = np.random.default_rng(0).integers(0, 256, size=(3, 40, 40, 3), dtype=np.uint8)
        out = RewardServer(engine).text_rewards_raw({{"X-Frames-Shape": "3,40,40,3", "X-Text": "coin"}},
                                                    frames.tobytes())
        assert len(out["rewards"]) == 3
        path = os.path.join(tmp, "d.hdf5")
        with h5py.File(path, "w") as g:
            g.create_dataset("ob", data=np.zeros((6, 2, 40, 40, 3), np.uint8))
            done = np.zeros((6, 2), bool)
            done[[2, 5], -1] = True
            g.create_dataset("done", data=done)
        for h in range(2):
            label_rewards(path, "coin", engine=engine, progress=False, num_hosts=2, host_index=h)
        merge_reward_shards(path)
        shard = convert_hdf5(path, os.path.join(tmp, "shards"), keys=["ob"])["ob"]
        assert ArpsReader(shard).read_batch([5]).shape == (1, 2, 40, 40, 3)
        cache_clip_embeddings(path, engine)
        assert not touched, touched
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_reference_checkpoint_and_collect_paths_read_nothing_of_the_jax_package(tmp_path):
    """With the JAX stack (and cloudpickle) blocked and the audit hook of the eval path's test: a policy is
    exported as a reference pickle and read back into a model, an M3AE tower is read by name from its
    ``.pkl``, a step is counted for cost/flops, and stage 1 collects, fuses and downsizes demos; nothing
    under arp_tpu/ is opened, loaded or compiled."""
    script = _SCRIPT.replace('"optax", "arp_tpu")', '"optax", "arp_tpu", "cloudpickle")') + textwrap.dedent(
        f"""
        import os, pickle, numpy as np, torch
        JAX_DIR = os.path.join({REPO!r}, "arp_tpu") + os.sep
        touched = []

        def audit(event, args):
            if event in ("open", "ctypes.dlopen", "subprocess.Popen", "os.listdir", "os.scandir"):
                for a in args:
                    items = a if isinstance(a, (list, tuple)) else [a]
                    for x in items:
                        if isinstance(x, (str, bytes, os.PathLike)):
                            p = os.path.realpath(os.fsdecode(x))
                            if p.startswith(JAX_DIR):
                                touched.append((event, p))

        sys.addaudithook(audit)
        from arp_tpu_torch.checkpoint import load_reference_checkpoint, reference_policy_state, save_reference_checkpoint
        from arp_tpu_torch.collect.downsize import downsize_by_resize
        from arp_tpu_torch.collect.fuse import fuse
        from arp_tpu_torch.collect.recorder import collect_demonstrations
        from arp_tpu_torch.config import Config
        from arp_tpu_torch.envs import FakeProcgen
        from arp_tpu_torch.models import m3ae
        from arp_tpu_torch.models.policy import ARPDT
        from arp_tpu_torch.parallel.step import TrainState, make_train_step
        from arp_tpu_torch.testing import scripted_coin_expert
        from arp_tpu_torch.train import common
        tmp = {str(tmp_path)!r}
        cfg = dict(model_type="vit_debug", emb_dim=32, depth=1, num_heads=4, use_discrete_action=True)
        rng = np.random.default_rng(0)
        batch = {{"image": {{"ob": rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)}},
                 "rtg": {{"ob": np.ones((2, 2, 1), np.float32)}}, "action": np.zeros((2, 2), np.int32),
                 "instruct": None, "text_padding_mask": None}}
        model = ARPDT(cfg, num_actions=15, patch_dim=16)
        with torch.no_grad():
            model(batch, deterministic=True)
        save_reference_checkpoint(os.path.join(tmp, "p.pkl"), model.trained_state_dict(), step=3, ensemble_mode="first")
        again = ARPDT(cfg, num_actions=15, patch_dim=16)
        with torch.no_grad():
            again(batch, deterministic=True)
            again.load_trained_state_dict(reference_policy_state(load_reference_checkpoint(os.path.join(tmp, "p.pkl"))))
        tower = m3ae.MaskedMultimodalAutoencoder(dict(model_type="custom", emb_dim=32, depth=1, num_heads=4),
                                                 text_vocab_size=97, image_output_dim=768)
        from arp_tpu_torch.models.policy import torch_policy_to_flax
        with open(os.path.join(tmp, "m3ae_base_params.pkl"), "wb") as f:
            pickle.dump(m3ae.export_reference_m3ae_params(torch_policy_to_flax(tower.state_dict())), f)
        tower.load_state_dict(m3ae.load_m3ae_model_vars("vit_b16", checkpoint_dir=tmp))
        state = TrainState.create(model, common.build_optimizer(Config(weight_decay=0.0, clip_gradient=1.0), lambda c: 1e-3, model))
        step = make_train_step(common.make_loss_fn(model, None, 32, False))
        assert common.flops_analysis(step.gradients, state, batch, torch.Generator().manual_seed(0)) > 0
        for name in ("a", "b"):
            env = FakeProcgen("coinrun", {{"episode_length": 20, "image_size": 32, "grid": 4}})
            collect_demonstrations(env, scripted_coin_expert, os.path.join(tmp, name, "data.hdf5"), num_episodes=2,
                                   num_frames=2)
        fuse(os.path.join(tmp, "a", "data.hdf5"), os.path.join(tmp, "b", "data.hdf5"), os.path.join(tmp, "f.hdf5"))
        downsize_by_resize(os.path.join(tmp, "f.hdf5"), os.path.join(tmp, "s.hdf5"), out_size=16, device="cpu")
        assert not touched, touched
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_ppg_and_resnet_paths_read_nothing_of_the_jax_package(tmp_path):
    """With the JAX stack (and cloudpickle) blocked and the audit hook of the eval path's test: a PPG expert
    trains on the native engine's venv and is written by the train CLI, evaluated from its pickle and
    collects demos through the collect CLI, a reference ``.jd`` state dict is loaded, and a ResNet CLIP
    engine labels frames; nothing under arp_tpu/ is opened, loaded or compiled."""
    script = _SCRIPT.replace('"optax", "arp_tpu")', '"optax", "arp_tpu", "cloudpickle")') + textwrap.dedent(
        f"""
        import os, numpy as np, torch
        JAX_DIR = os.path.join({REPO!r}, "arp_tpu") + os.sep
        touched = []

        def audit(event, args):
            if event in ("open", "ctypes.dlopen", "subprocess.Popen", "os.listdir", "os.scandir"):
                for a in args:
                    items = a if isinstance(a, (list, tuple)) else [a]
                    for x in items:
                        if isinstance(x, (str, bytes, os.PathLike)):
                            p = os.path.realpath(os.fsdecode(x))
                            if p.startswith(JAX_DIR):
                                touched.append((event, p))

        sys.addaudithook(audit)
        from arp_tpu_torch.collect import collect, eval_ppg, train_ppg
        from arp_tpu_torch.collect.convert_ppg import load_reference_ppg_expert, torch_ppg_to_flax
        from arp_tpu_torch.collect.ppg import PhasicValueModel
        from arp_tpu_torch.models.clip import CLIP
        from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
        from arp_tpu_torch.reward.engine import ClipRewardEngine
        tmp = {str(tmp_path)!r}
        ckpt = os.path.join(tmp, "ppg.pkl")
        train_ppg.main(["--device=cpu", "--vec_env=native", "--num_envs=2", "--segment_length=4",
                        "--total_iterations=1", "--n_pi=1", "--n_aux_epochs=1", "--episode_length=6",
                        "--checkpoint_path=" + ckpt, "--logging.output_dir=" + os.path.join(tmp, "log")])
        eval_ppg.main(["--device=cpu", "--checkpoint=" + ckpt, "--fake_env", "--num_episodes=1", "--num_envs=1"])
        collect.main(["--device=cpu", "--fake_env=True", "--num_episodes=1", "--num_frames=2", "--episode_length=8",
                      "--enable_filter=False", "--model_path=" + ckpt, "--out_dir=" + os.path.join(tmp, "demos")])
        import re
        sd = {{}}
        for name, value in PhasicValueModel(frame_shape=(64, 64, 3)).state_dict().items():  # the reference's names
            name = re.sub(r"_enc\\.stack(\\d)_block(\\d)_", r"_enc.cnn.stacks.\\1.blocks.\\2.", name)
            name = re.sub(r"_enc\\.stack(\\d)_firstconv", r"_enc.cnn.stacks.\\1.firstconv", name)
            name = name.replace("_enc.dense", "_enc.cnn.dense")
            sd["vf_vhead" + name[len("vf_head"):] if name.startswith("vf_head") else name] = value
        torch.save(sd, os.path.join(tmp, "sd.jd"))
        model, _ = load_reference_ppg_expert(os.path.join(tmp, "sd.jd"))
        assert model(torch.zeros(1, 64, 64, 3))[0].shape == (1, 15)
        engine = ClipRewardEngine(model=CLIP(embed_dim=16, vocab_size=97, vision_num_layers=(1, 1, 1, 1),
                                             vision_features=8, text_features=16, text_num_heads=4,
                                             text_num_layers=1, image_size=64),
                                  batch_size=2, device="cpu", tokenizer=Char97Tokenizer())
        frames = np.random.default_rng(0).integers(0, 256, size=(3, 80, 80, 3), dtype=np.uint8)
        assert np.isfinite(engine.text_rewards(frames, "coin")).all()
        assert not touched, touched
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_pretrain_and_resnet_paths_read_nothing_of_the_jax_package(tmp_path):
    """With the JAX stack blocked and the audit hook of the eval path's test: the M3AE pretraining CLI trains a
    tiny autoencoder on a synthetic demo file and writes its checkpoint, and a ResNet18 runs a train-mode
    forward; nothing under arp_tpu/ is opened, loaded or compiled."""
    script = _SCRIPT + textwrap.dedent(
        f"""
        import os, numpy as np, torch
        JAX_DIR = os.path.join({REPO!r}, "arp_tpu") + os.sep
        touched = []

        def audit(event, args):
            if event in ("open", "ctypes.dlopen", "subprocess.Popen", "os.listdir", "os.scandir"):
                for a in args:
                    items = a if isinstance(a, (list, tuple)) else [a]
                    for x in items:
                        if isinstance(x, (str, bytes, os.PathLike)):
                            p = os.path.realpath(os.fsdecode(x))
                            if p.startswith(JAX_DIR):
                                touched.append((event, p))

        sys.addaudithook(audit)
        from tests.test_trainer_e2e import DATASET, make_labeled_dataset
        from arp_tpu_torch.models.resnet import ResNet18
        from arp_tpu_torch.train import pretrain_m3ae
        tmp = {str(tmp_path)!r}
        make_labeled_dataset(os.path.join(tmp, "demos"), n=8)
        pretrain_m3ae.main(["--device=cpu", "--epochs=1", "--batch_size=8", "--patch_size=8", "--image_size=32",
                            "--text_length=16", "--dataset_name=" + DATASET, "--model.model_type=custom",
                            "--model.emb_dim=16", "--model.dec_emb_dim=8", "--model.depth=1", "--model.dec_depth=1",
                            "--model.num_heads=2", "--model.dec_num_heads=2", "--model.mlp_ratio=2",
                            "--data.path=" + os.path.join(tmp, "demos"), "--data.image_size=32",
                            "--data.num_frames=8", "--data.window_size=4",
                            "--checkpoint_dir=" + os.path.join(tmp, "ckpt"),
                            "--logging.output_dir=" + os.path.join(tmp, "log")])
        assert os.listdir(os.path.join(tmp, "ckpt")) == ["step_1.pt"]
        assert ResNet18(num_outputs=3, num_filters=4)(torch.zeros(2, 32, 32, 3), train=True).shape == (2, 3)
        assert not touched, touched
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
