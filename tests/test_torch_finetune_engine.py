"""The port's clip_ft reward engine, the engine's unpacked preprocessing, the quadruple dataset, the
OpenAI checkpoint loader and the two CLIs against arp_tpu's, on the same weights and inputs.

Tolerances: reward MAE 1e-4 (BASELINE.json's target) for float32 engines; the bf16 and int8
recipes against JAX's engine of the same recipe with a bound just above the difference measured
here, which the float32 recipe must fail (so the test tells the recipes apart).  The CLIs run on
the CPU: the labelers on one synthetic HDF5 file and one adapter pickle, a tiny CLIP standing in
for "vit_b16" (a test-time entry of both packages' CONFIGS) and read from a local OpenAI-layout
checkpoint by both ``load_model_vars``.
"""

import os
import pickle
import shutil
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu.finetune.adapter_model import ClipMultiscaleAdapter as JAdapter
from arp_tpu.finetune.dataset import ProcgenActionDataset as JDataset
from arp_tpu.finetune.reward import ClipFtRewardEngine as JEngine
from arp_tpu.models.clip import model as jclip_model
from arp_tpu.models.clip.convert import convert_torch_clip_vars as j_convert
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, make_tiny_clip_engine
from arp_tpu_torch.finetune import train as tft
from arp_tpu_torch.finetune.convert import flax_adapter_to_torch
from arp_tpu_torch.finetune.dataset import ProcgenActionDataset
from arp_tpu_torch.finetune.reward import ClipFtRewardEngine, load_adapter_params
from arp_tpu_torch.models.clip import CLIP, convert_torch_clip_vars, flax_to_torch, load_model_vars
from arp_tpu_torch.models.clip import model as tclip_model
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.reward import labeler as tlabeler
from arp_tpu_torch.reward.engine import ClipRewardEngine
from test_finetune import TINY_CFG, TinyAdapter, make_batch, tiny_tokens

MAE = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frames(seed, n, size=48):
    return np.random.default_rng(seed).integers(0, 256, size=(n, size, size, 3), dtype=np.uint8)


# --- the base engine's unpacked preprocessing ------------------------------------------------------


@pytest.mark.parametrize("option", [dict(resize_mode="fast"), dict(use_crop=True),
                                    dict(resize_mode="fast", use_crop=True)], ids=["fast", "crop", "fast_crop"])
def test_unpacked_engine_matches_jax(option):
    jax_engine = make_tiny_clip_engine(batch_size=8, **option)
    port = ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE), batch_size=8, device="cpu",
                            variables=jax.tree_util.tree_map(np.asarray, jax_engine.variables),
                            tokenizer=Char97Tokenizer(), **option)
    assert not port._packed
    frames = _frames(1, 11, 64)
    got, want = port.text_rewards(frames, "collect the coin."), jax_engine.text_rewards(frames, "collect the coin.")
    assert np.abs(got - want).mean() <= MAE
    assert np.abs(port.goal_rewards(frames) - jax_engine.goal_rewards(frames)).mean() <= MAE
    assert port.encode_recipe.split(";", 1)[1] == jax_engine.encode_recipe.split(";", 1)[1]
    with pytest.warns(UserWarning, match="packed ViT pipeline"):  # as in JAX: the standard path runs
        fast = ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE), batch_size=8,
                                device="cpu", variables=jax.tree_util.tree_map(np.asarray, jax_engine.variables),
                                tokenizer=Char97Tokenizer(), fast_encode=True, **option)
    assert fast._fast is None
    np.testing.assert_array_equal(fast.text_rewards(frames, "collect the coin."), got)


# --- the clip_ft engine --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ft_setup():
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.normal(size=(1, 224, 224, 3)).astype(np.float32))
    clip_vars = jclip_model.CLIP(**TINY_CFG).init(jax.random.PRNGKey(0), img, jnp.asarray(tiny_tokens(1)))
    model = TinyAdapter(action_dim=15)
    params = model.init({"params": jax.random.PRNGKey(1), "aug": jax.random.PRNGKey(2)}, clip_vars,
                        make_batch(rng), train=False)["params"]
    return model, clip_vars, params


def engines(ft_setup, **mode):
    model, clip_vars, params = ft_setup
    kw = dict(batch_size=4, image_size=224, tokenizer=lambda text: tiny_tokens(1), clip_config=TINY_CFG)
    jax_engine = JEngine(adapter_params=params, clip_variables=clip_vars, adapter=model, **kw, **mode)
    port = ClipFtRewardEngine(adapter_params=flax_adapter_to_torch(jax.tree_util.tree_map(np.asarray, params)),
                              clip_variables=jax.tree_util.tree_map(np.asarray, clip_vars), device="cpu", **kw, **mode)
    return jax_engine, port


@pytest.mark.parametrize("crop", [False, True], ids=["whole", "crop"])
def test_clip_ft_engine_module_f32_matches_jax(ft_setup, crop):
    jax_engine, port = engines(ft_setup, use_crop=crop)
    frames = _frames(21, 6, 32)
    got, want = port.text_rewards(frames, "get the coin"), jax_engine.text_rewards(frames, "get the coin")
    assert got.shape == want.shape == (6,) and np.abs(got - want).mean() <= MAE
    goal = port.goal_rewards(frames, goal_index=-1)
    assert np.abs(goal - jax_engine.goal_rewards(frames, goal_index=-1)).mean() <= MAE and goal[-1] == 0.0
    feats = port.encode_image_features(frames, normalize=False)  # normalized whatever normalize says
    np.testing.assert_allclose(np.linalg.norm(feats, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(feats, port.encode_image_features(frames, normalize=True))
    assert port.encode_recipe == f"torch;clip_ft;module;float32;resize=fast;crop={int(crop)}"


# JAX's packed engines against the port's of the same recipe, on the CPU, reward MAE on 6 frames.
# int8 (with int8 attention, JAX's default): measured 0.0022 here, the float32 recipe 0.060 from
# JAX's int8 engine; the bound sits just above the first.  bf16: measured 0.00057, and the float32
# recipe is as close (0.00059): the two CPU backends round bf16 at other places (XLA fuses its
# converts, torch's CPU matmuls sum in their own order), and at these widths those roundings move
# the features as much as bf16 does; so the bf16 case holds the bound and shows that the engine
# ran bf16 by its distance from the port's float32 engine (measured 0.0008).
FAST_BOUND = {"fast_bf16": 1e-3, "fast_int8": 3e-3}


@pytest.mark.parametrize("label", list(FAST_BOUND))
def test_clip_ft_engine_packed_recipes_match_jax(ft_setup, label):
    mode = dict(fast_encode=True) if label == "fast_bf16" else dict(fast_int8=True)
    jax_engine, port = engines(ft_setup, **mode)
    _, f32 = engines(ft_setup)
    frames = _frames(5, 6, 32)
    want = jax_engine.text_rewards(frames, "get the coin")  # the int8 engines calibrate on this first batch
    got = port.text_rewards(frames, "get the coin")
    base = f32.text_rewards(frames, "get the coin")
    assert port._fast is not None and (port._fast_q is not None) == ("int8" in label)
    mae, f32_mae, own = (float(np.abs(a - b).mean()) for a, b in ((got, want), (base, want), (got, base)))
    print(f"{label}: MAE vs JAX {mae:.6f}, float32 recipe vs JAX {f32_mae:.6f}, vs the port's float32 {own:.6f}")
    assert mae <= FAST_BOUND[label]
    if label == "fast_int8":
        assert f32_mae > 10 * FAST_BOUND[label]  # the bound tells the int8 recipe from float32
    else:
        assert own > 2e-4  # bf16 ran: the rewards moved from the float32 engine's


def test_clip_ft_engine_refuses_a_mesh(ft_setup):
    """A mesh is ported (tests/test_torch_mesh_engine.py): what is not a local-device mesh, and a mesh that
    does not divide the batch, raise."""
    from arp_tpu_torch.parallel.mesh import LocalMesh

    _, clip_vars, params = ft_setup
    kw = dict(clip_config=TINY_CFG, clip_variables=jax.tree_util.tree_map(np.asarray, clip_vars), device="cpu")
    adapter = flax_adapter_to_torch(jax.tree_util.tree_map(np.asarray, params))
    with pytest.raises(TypeError, match="local-device mesh"):
        ClipFtRewardEngine(adapter, mesh=object(), **kw)
    with pytest.raises(ValueError, match="divisible"):
        ClipFtRewardEngine(adapter, batch_size=6, mesh=LocalMesh(["cpu"] * 4), **kw)


# --- the OpenAI checkpoint loader ----------------------------------------------------------------


def openai_state_dict(cfg: dict, image_size: int, seed: int) -> dict:
    """A random CLIP ViT state dict in the OpenAI layout (fused in_proj, Conv2d patch embedding), numpy."""
    rng = np.random.default_rng(seed)
    sd = {}

    def normal(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    def blocks(prefix, width, layers):
        for i in range(layers):
            p = f"{prefix}resblocks.{i}."
            for ln in ("ln_1", "ln_2"):
                sd[p + ln + ".weight"], sd[p + ln + ".bias"] = 1 + normal(width), normal(width)
            sd[p + "attn.in_proj_weight"], sd[p + "attn.in_proj_bias"] = normal(3 * width, width), normal(3 * width)
            sd[p + "attn.out_proj.weight"], sd[p + "attn.out_proj.bias"] = normal(width, width), normal(width)
            sd[p + "mlp.c_fc.weight"], sd[p + "mlp.c_fc.bias"] = normal(4 * width, width), normal(4 * width)
            sd[p + "mlp.c_proj.weight"], sd[p + "mlp.c_proj.bias"] = normal(width, 4 * width), normal(width)

    fv, ft, e, patch = cfg["vision_features"], cfg["text_features"], cfg["embed_dim"], cfg["vision_patch_size"]
    sd["visual.conv1.weight"] = normal(fv, 3, patch, patch)
    sd["visual.class_embedding"] = normal(fv)
    sd["visual.positional_embedding"] = normal((image_size // patch) ** 2 + 1, fv)
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"], sd[f"visual.{ln}.bias"] = 1 + normal(fv), normal(fv)
    blocks("visual.transformer.", fv, cfg["vision_num_layers"])
    sd["visual.proj"] = normal(fv, e)
    sd["token_embedding.weight"] = normal(cfg["vocab_size"], ft)
    sd["positional_embedding"] = normal(77, ft)
    blocks("transformer.", ft, cfg["text_num_layers"])
    sd["ln_final.weight"], sd["ln_final.bias"] = 1 + normal(ft), normal(ft)
    sd["text_projection"] = normal(ft, e)
    sd["logit_scale"] = np.asarray(np.log(100.0), np.float32)
    sd["input_resolution"], sd["context_length"], sd["vocab_size"] = image_size, 77, cfg["vocab_size"]
    return sd


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, prefix + (k,)) if hasattr(v, "items") else {prefix + (k,): np.asarray(v)})
    return out


class _Archive(torch.nn.Module):
    """A module whose state dict holds ``sd``'s tensors under their dotted names (for a .pt jit archive)."""

    def __init__(self, sd):
        super().__init__()
        for name, value in sd.items():
            *mods, leaf = name.split(".")
            node = self
            for m in mods:
                if not hasattr(node, m):
                    node.add_module(m, torch.nn.Module())
                node = getattr(node, m)
            node.register_buffer(leaf, torch.as_tensor(np.asarray(value)))

    def forward(self, x):
        return x


def test_load_model_vars_matches_jax(tmp_path, monkeypatch):
    """A .npy state dict and a .pt jit archive, under ARP_TPU_CHECKPOINT_DIR, into the Flax layout as
    arp_tpu's converter gives it, leaf for leaf, a ResNet checkpoint with its batch_stats too; a missing
    file raises."""
    sd = openai_state_dict(TINY_CLIP_CFG, 32, seed=3)
    np.save(tmp_path / "tiny.npy", sd, allow_pickle=True)
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path))
    want = _leaves(jax.tree_util.tree_map(np.asarray, j_convert(sd)))
    got = _leaves(load_model_vars("tiny"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    torch.jit.script(_Archive({k: v for k, v in sd.items() if isinstance(v, np.ndarray)})).save(
        str(tmp_path / "tiny.pt"))
    from_pt = _leaves(load_model_vars("tiny", checkpoint_path=str(tmp_path / "tiny.pt")))
    assert from_pt.keys() == want.keys() and all(np.array_equal(from_pt[k], want[k]) for k in want)
    CLIP(**TINY_CLIP_CFG, image_size=32).load_state_dict(flax_to_torch(load_model_vars("tiny")))  # strict
    with pytest.raises(FileNotFoundError, match="fetching it is not ported"):
        load_model_vars("vit_b16")
    from tests.test_torch_clip_resnet import _openai_resnet_state_dict

    _, rn = _openai_resnet_state_dict(5)
    np.save(tmp_path / "resnet_50.npy", rn, allow_pickle=True)
    want = _leaves(jax.tree_util.tree_map(np.asarray, j_convert(rn)))
    got = _leaves(load_model_vars("resnet_50"))
    assert got.keys() == want.keys() and any(k[0] == "batch_stats" for k in got)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert _leaves(convert_torch_clip_vars(rn)).keys() == want.keys()


# --- the dataset -----------------------------------------------------------------------------------


class Tok:
    def __call__(self, text):
        return np.full((1, 77), len(text), np.int32)


def test_quadruple_dataset_matches_jax(tmp_path):
    root = tmp_path / "demos" / "maze_hard"
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    n, f = 40, 3
    with h5py.File(root / "data_train.hdf5", "w") as g:
        g.create_dataset("ob", data=rng.integers(0, 256, size=(n, f, 8, 8, 3), dtype=np.uint8))
        g.create_dataset("act", data=rng.integers(0, 15, size=(n, f)).astype(np.int64))
        done = np.zeros((n, f), bool)
        done[9, -1] = done[30, -1] = done[n - 1, -1] = True
        g.create_dataset("done", data=done)
    for extra in ({}, {"action_at": "traj_start", "start_index": 2, "max_length": 30}, {"env_type": "aisc"}):
        cfg = {"path": str(tmp_path / "demos"), "image_key": "ob", "threshold": 6, **extra}
        mine = ProcgenActionDataset(cfg, dataset_name="maze_hard", split="train", tokenizer=Tok())
        ref = JDataset(cfg, dataset_name="maze_hard", split="train", tokenizer=Tok())
        assert len(mine) == len(ref) and mine.num_actions == ref.num_actions and mine.env_name == ref.env_name
        np.testing.assert_array_equal(mine.idx_to_traj, ref.idx_to_traj)
        assert mine.traj_idx == ref.traj_idx
        for i in range(len(mine)):
            a, b = mine[i], ref[i]
            assert a.keys() == b.keys()
            for k in ("r", "instruct", "action"):
                np.testing.assert_array_equal(a[k], b[k])
                assert a[k].dtype == b[k].dtype
            for j in range(4):
                np.testing.assert_array_equal(a[f"image{j}"]["ob"], b[f"image{j}"]["ob"])
        for index, traj in ((5, list(range(10))), (20, list(range(10, 31))), (31, [30, 31, 32])):
            for seed in range(3):
                assert mine.sample_next_index(index, traj, np.random.default_rng(seed)) == \
                    ref.sample_next_index(index, traj, rng=np.random.default_rng(seed))


# --- the CLIs --------------------------------------------------------------------------------------

CLI_CLIP = dict(tft.TINY_CLIP)  # the tiny_test config with a vocabulary that holds the tokenizer's ids


def _demo_file(path, n=12, f=2, size=48, seed=4):
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as g:
        g.create_dataset("ob", data=rng.integers(0, 256, size=(n, f, size, size, 3), dtype=np.uint8))
        g.create_dataset("act", data=rng.integers(0, 15, size=(n, f)).astype(np.int64))
        done = np.zeros((n, f), bool)
        done[n // 2 - 1, -1] = done[n - 1, -1] = True
        g.create_dataset("done", data=done)


@pytest.mark.parametrize("fast", [False, True], ids=["module", "fast"])
def test_labeler_clip_ft_matches_the_jax_labeler(tmp_path, monkeypatch, capsys, fast):
    """Both labelers' CLIs with --model_type clip_ft --model_ckpt_dir on one adapter pickle, "vit_b16"
    read from a local OpenAI-layout checkpoint: the same rewards."""
    monkeypatch.setitem(jclip_model.CONFIGS, "vit_b16", CLI_CLIP)
    monkeypatch.setitem(tclip_model.CONFIGS, "vit_b16", CLI_CLIP)
    np.save(tmp_path / "vit_b16.npy", openai_state_dict(CLI_CLIP, 224, seed=5), allow_pickle=True)
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path))
    adapter = JAdapter(clip_model_name="vit_b16")
    clip_vars = jclip_model.load_model_vars("vit_b16")
    batch = make_batch(np.random.default_rng(6))
    params = adapter.init({"params": jax.random.PRNGKey(7), "aug": jax.random.PRNGKey(8)}, clip_vars, batch,
                          train=False)["params"]
    with open(tmp_path / "adapter.pkl", "wb") as f:
        pickle.dump({"params": jax.tree_util.tree_map(np.asarray, params)}, f)
    port_path, jax_path = str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")
    _demo_file(port_path)
    shutil.copy(port_path, jax_path)
    common = ["--model_type", "clip_ft", "--model_ckpt_dir", str(tmp_path / "adapter.pkl"), "--batch_size", "8",
              *(["--fast"] if fast else [])]
    tlabeler.main(["--data_path", port_path, "--device", "cpu", *common])
    from arp_tpu.reward import labeler as jlabeler

    monkeypatch.setattr(sys, "argv", ["labeler", "--data_path", jax_path, *common])
    jlabeler.main()
    # float32: BASELINE.json's MAE; --fast: the engine test's bf16 bound (FAST_BOUND, at logit_scale 1)
    # times this checkpoint's exp(logit_scale) = 100; a return-to-go sums the 6 rewards of a trajectory
    bound = FAST_BOUND["fast_bf16"] * 100 if fast else MAE
    with h5py.File(port_path, "r") as a, h5py.File(jax_path, "r") as b:
        for key in ("ob_clip_ft_reward", "ob_clip_ft_pos_rtg"):
            assert a[key].shape == b[key].shape == (12, 2)
            assert np.abs(a[key][:] - b[key][:]).mean() <= bound * (6 if "rtg" in key else 1), key
        recipe = a["ob_clip_ft_reward"].attrs["encode_recipe"]
        assert recipe.startswith("torch;clip_ft;" + ("packed;bfloat16" if fast else "module;float32")), recipe
    with pytest.raises(ValueError, match="model_ckpt_dir"):
        tlabeler.main(["--data_path", port_path, "--device", "cpu", "--model_type", "clip_ft"])


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """The port's fine-tuning CLI, one epoch on a tiny synthetic file (a subprocess, as a user runs it)."""
    tmp = tmp_path_factory.mktemp("ft")
    root = tmp / "demos" / "coinrun_tiny"
    root.mkdir(parents=True)
    for seed, split in enumerate(("train", "val")):
        _demo_file(root / f"data_{split}.hdf5", n=16, f=2, size=32, seed=seed)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, ARP_TPU_TINY_CLIP="1", OMP_NUM_THREADS="2")
    ckpt, out = tmp / "ckpt", tmp / "log"
    cmd = [sys.executable, "-m", "arp_tpu_torch.finetune.train", "--device=cpu", "--epochs=1", "--batch_size=4",
           "--log_freq=1", "--use_tcn_loss=True", "--dataset_name=coinrun_tiny", "--clip_model=tiny_test",
           "--clip_checkpoint=random", f"--checkpoint_dir={ckpt}", f"--data.path={tmp / 'demos'}",
           "--data.image_key=ob", f"--logging.output_dir={out}"]
    proc = subprocess.run(cmd, env=env, cwd=str(tmp), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return ckpt, out


def test_finetune_cli_trains_and_writes_best_and_final(finetuned):
    import json

    ckpt, out = finetuned
    run = os.path.join(out, os.listdir(out)[0])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "train_loss" in r]
    assert len(train) == 4 and all(np.isfinite(r["train_loss"]) for r in train)  # 16 // 4 steps, logged each
    assert all(k in train[0] for k in ("train_ob_vip_loss", "train_ob_id_loss", "train_ob_tcn_loss", "train_ob_id_acc"))
    val = [r for r in records if "val_loss" in r]
    assert len(val) == 1 and np.isfinite(val[0]["val_loss"])
    assert sorted(os.listdir(ckpt)) == ["best.json", "best.pt", "step_4.pt"]
    # the labeler's reader takes the best model; it fits a clip_ft engine on the same tiny tower
    state = load_adapter_params(str(ckpt))
    final = torch.load(os.path.join(ckpt, "step_4.pt"), weights_only=True)
    assert final["optimizer"]["count"] == 4 and final["metadata"]["epoch"] == 1
    assert all(torch.equal(state[k], final["state"][k]) for k in state)  # one epoch: best is the final state
    moved = torch.load(os.path.join(ckpt, "best.pt"), weights_only=True)["state"]["lambda_id"]
    assert float(moved) != pytest.approx(np.log(1 / 0.07), abs=1e-7)  # every parameter decays and moves
    torch.manual_seed(0)
    engine = ClipFtRewardEngine(state, model=CLIP(**CLI_CLIP, image_size=224), clip_config=CLI_CLIP, batch_size=4,
                                device="cpu")
    rewards = engine.text_rewards(_frames(2, 5, 32), "collect the coin")
    assert rewards.shape == (5,) and np.isfinite(rewards).all()


def test_unported_paths_raise(tmp_path):
    # several processes are ported; in one, --mesh_dp=2 fails JAX's mesh assertion
    with pytest.raises(AssertionError, match="mesh 2x1x1x1 != 1 devices"):
        tft.main(["--device=cpu", "--mesh_dp=2"])
    # a directory with neither the port's files nor an orbax item (JAX's last candidate is the directory itself)
    orbax_like = tmp_path / "orbax"
    (orbax_like / "best").mkdir(parents=True)
    with pytest.raises(FileNotFoundError, match="not an orbax checkpoint item"):
        load_adapter_params(str(orbax_like))
