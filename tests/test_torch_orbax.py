"""The JAX package's checkpoints read by the port without jax: its orbax directories (ROADMAP 10b) and
its adapter pickles (F7).

The JAX package's own ``arp_tpu.checkpoint.CheckpointManager`` (and ``save_pickle``) write every file
inside the test, at narrow widths: a dict state of float32, bfloat16 and int32 leaves and a tuple; a
policy ``TrainState`` (vit_debug-like, transfer ``none``) through ``save`` and ``save_best``; the older
flat ``best/state`` layout; an adapter ``TrainState`` through ``save_best``; the adapter as
``{"state": TrainState}`` and as ``{"params": <jax arrays>}`` pickles.  One subprocess, with jax,
jaxlib, flax, orbax, optax, cloudpickle and arp_tpu blocked by a ``sys.meta_path`` finder, reads them
all through the port (``checkpoint.load_orbax_item``, the eval CLI's restore, the labeler's
``--model_type clip_ft --model_ckpt_dir``) and leaves what it read for the tests below, which hold it
against the JAX package's own readers:

* every leaf bit-equal, dtype kept (bfloat16 compared as its bits);
* the port's eval restore gives ``action_pred`` within 1e-5 of JAX's eval restore on the same directory;
* clip_ft rewards from the orbax directory and from both pickles within 1e-4 MAE of JAX's labeler.

In this process: the server's ``load_latest`` picks up a step written after its first load, a missing
tensorstore raises an ImportError that names it, and the resuming CLIs refuse a JAX-only directory.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch
from flax.training.train_state import TrainState

from arp_tpu import checkpoint as jckpt
from arp_tpu.finetune.adapter_model import ClipMultiscaleAdapter as JAdapter
from arp_tpu.models.clip import model as jclip_model
from arp_tpu.models.policy import models as jpol
from arp_tpu_torch import checkpoint as tckpt
from arp_tpu_torch import serve as tserve
from arp_tpu_torch.models.policy import convert as tconvert
from arp_tpu_torch.models.policy import models as tpol
from test_finetune import make_batch as adapter_batch
from test_torch_finetune_engine import CLI_CLIP, _demo_file, openai_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
MAE = 1e-4
PATCH = 16
CFG = dict(model_type="vit_debug", transfer_type="none", emb_dim=32, depth=2, num_heads=4, mlp_ratio=2,
           use_discrete_action=True, num_ensembles=2)
BLOCKED = ("jax", "jaxlib", "flax", "orbax", "optax", "cloudpickle", "arp_tpu")
ADAPTER_SOURCES = ("orbax_best", "pickle_state", "pickle_params")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def policy_batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": {"ob": rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32)},
            "rtg": {"ob": rng.normal(size=(2, 2, 1)).astype(np.float32)},
            "action": rng.integers(0, 15, size=(2, 2)).astype(np.int32), "instruct": None, "text_padding_mask": None}


def jax_policy(seed):
    """A Flax ARPDT and seeded params moved off the init (float32)."""
    model = jpol.ARPDT(config_updates=CFG, num_actions=15, patch_dim=PATCH)
    rngs = {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    params = model.init(rngs, jax.tree_util.tree_map(jnp.asarray, policy_batch(0)), deterministic=True)["params"]
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map(lambda p: jnp.asarray(np.asarray(p) + 0.05 * rng.normal(size=p.shape),
                                                               jnp.float32), params)


def policy_train_state(params):
    """The trainer's optimizer shape: clip_by_global_norm + adamw on a schedule."""
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     optax.adamw(optax.cosine_decay_schedule(1e-3, 10), weight_decay=5e-5))
    return TrainState.create(apply_fn=None, params=params, tx=tx)


def port_policy(state_dict):
    model = tpol.ARPDT(CFG, num_actions=15, patch_dim=PATCH).eval()
    with torch.no_grad():
        model(policy_batch(1), deterministic=True)  # the lazy layers take their shapes
        model.load_trained_state_dict(state_dict)
    return model


MIXED = {"params": {"w": np.arange(15, dtype=np.float32).reshape(3, 5) / 7,
                    "b": (np.arange(7, dtype=np.float32) / 3 - 1),  # stored as bfloat16
                    "n": np.int32(-9)},
         "opt": (np.int32(3), {"mu": np.linspace(-1, 1, 4, dtype=np.float32)})}


def mixed_state():
    return jax.tree_util.tree_map(jnp.asarray, {**MIXED, "params": {**MIXED["params"], "b": jnp.asarray(
        MIXED["params"]["b"], jnp.bfloat16)}})


def _flat(tree, prefix=()):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


_READ = textwrap.dedent("""
    import json, os, sys

    BLOCKED = {blocked!r}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import of {{name}}")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np, torch
    from arp_tpu_torch import checkpoint as c
    from arp_tpu_torch.models.clip import model as tclip_model
    from arp_tpu_torch.models.policy import models as tpol
    from arp_tpu_torch.reward import labeler
    from arp_tpu_torch.train.eval import restore_policy_state

    root = {root!r}
    out = {{}}
    tree, meta = c.load_orbax_item(os.path.join(root, "mixed", "4", "state"))
    flat = {{}}

    def walk(node, prefix):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            if isinstance(v, (dict, list)):
                walk(v, prefix + (str(k),))
            else:
                flat["/".join(prefix + (str(k),))] = v

    walk(tree, ())
    out["mixed_meta"] = meta
    out["mixed_kinds"] = {{k: type(v).__name__ for k, v in flat.items()}}
    arrays = {{k: (v.view(np.uint16) if v.dtype.name == "bfloat16" else v) for k, v in flat.items()
              if isinstance(v, np.ndarray)}}
    out["mixed_dtypes"] = {{k: v.dtype.name for k, v in flat.items() if isinstance(v, np.ndarray)}}
    out["mixed_sequence"] = isinstance(tree["opt"], list)
    # a bfloat16 leaf as a torch tensor keeps its bits and its values
    bf16 = flat["params/b"]
    as_torch = c.array_to_torch(bf16)
    out["bf16_bits_kept"] = bool(as_torch.dtype == torch.bfloat16
                                 and np.array_equal(as_torch.view(torch.int16).numpy(), bf16.view(np.int16))
                                 and np.array_equal(as_torch.float().numpy(), bf16.astype(np.float32)))

    batch = dict(np.load(os.path.join(root, "batch.npz")))
    batch = {{"image": {{"ob": batch["image"]}}, "rtg": {{"ob": batch["rtg"]}}, "action": batch["action"],
              "instruct": None, "text_padding_mask": None}}
    cfg = {cfg!r}
    for name in ("policy", "legacy"):
        if name == "policy":
            state, meta = restore_policy_state(os.path.join(root, "policy"))
        else:
            params = c.params_of(c.load_orbax_item(c.orbax_best_state_dir(os.path.join(root, "legacy")))[0])
            from arp_tpu_torch.models.policy.convert import flax_policy_to_torch
            state, meta = flax_policy_to_torch(params), {{}}
        model = tpol.ARPDT(cfg, num_actions=15, patch_dim=16).eval()
        with torch.no_grad():
            model(batch, deterministic=True)
            model.load_trained_state_dict(state)
            arrays[f"{{name}}_action_pred"] = model(batch, deterministic=True)["action_pred"].numpy()
        out[f"{{name}}_meta"] = meta

    tclip_model.CONFIGS["vit_b16"] = {clip_cfg!r}
    for source, ckpt in {sources!r}.items():
        labeler.main(["--data_path", os.path.join(root, f"port_{{source}}.hdf5"), "--device", "cpu",
                      "--model_type", "clip_ft", "--model_ckpt_dir", ckpt, "--batch_size", "8"])
    np.savez(os.path.join(root, "port_read.npz"), **arrays)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    out["blocked_modules_loaded"] = bad
    print("READ " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """Every file the JAX package writes, then the port's blocked read of them; returns what both read."""
    root = tmp_path_factory.mktemp("jax_checkpoints")
    mngr = jckpt.CheckpointManager(str(root / "mixed"))
    mngr.save(4, mixed_state(), {"epoch": 2}, wait=True)
    mngr.close()

    jmodel, params = jax_policy(3)
    state = policy_train_state(params)
    mngr = jckpt.CheckpointManager(str(root / "policy"))
    mngr.save(3, state, {"epoch": 1}, wait=True)
    mngr.save_best(3, state, 0.5, {"epoch": 1})
    mngr.close()
    ocp.Checkpointer(ocp.StandardCheckpointHandler()).save(str(root / "legacy" / "best" / "state"), state)
    batch = policy_batch(2)
    np.savez(root / "batch.npz", image=batch["image"]["ob"], rtg=batch["rtg"]["ob"], action=batch["action"])

    # the adapter over a tiny CLIP standing in for "vit_b16", read by both labelers from an OpenAI-layout file
    saved_cfg = jclip_model.CONFIGS["vit_b16"]
    jclip_model.CONFIGS["vit_b16"] = CLI_CLIP
    try:
        np.save(root / "vit_b16.npy", openai_state_dict(CLI_CLIP, 224, seed=5), allow_pickle=True)
        os.environ["ARP_TPU_CHECKPOINT_DIR"] = str(root)
        adapter = JAdapter(clip_model_name="vit_b16")
        clip_vars = jclip_model.load_model_vars("vit_b16")
        aparams = adapter.init({"params": jax.random.PRNGKey(7), "aug": jax.random.PRNGKey(8)}, clip_vars,
                               adapter_batch(np.random.default_rng(6)), train=False)["params"]
        astate = TrainState.create(apply_fn=None, params=aparams, tx=optax.adamw(1e-4))
        mngr = jckpt.CheckpointManager(str(root / "adapter"))
        mngr.save_best(5, astate, 1.0, {"epoch": 2})
        mngr.close()
        jckpt.save_pickle({"step": 5, "state": astate}, str(root / "adapter_state.pkl"))
        jckpt.save_pickle({"params": aparams}, str(root / "adapter_params.pkl"))
        sources = {"orbax_best": str(root / "adapter"), "pickle_state": str(root / "adapter_state.pkl"),
                   "pickle_params": str(root / "adapter_params.pkl")}
        _demo_file(str(root / "demo.hdf5"))
        for source in sources:
            for side in ("port", "jax"):
                shutil.copy(root / "demo.hdf5", root / f"{side}_{source}.hdf5")

        script = _READ.format(blocked=BLOCKED, root=str(root), cfg=CFG, clip_cfg=CLI_CLIP, sources=sources)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = REPO
        proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:] + proc.stdout[-2000:]
        read = json.loads(proc.stdout.split("READ ", 1)[1].splitlines()[0])

        from arp_tpu.reward import labeler as jlabeler

        argv = sys.argv
        for source, ckpt in sources.items():
            sys.argv = ["labeler", "--data_path", str(root / f"jax_{source}.hdf5"), "--model_type", "clip_ft",
                        "--model_ckpt_dir", ckpt, "--batch_size", "8"]
            jlabeler.main()
        sys.argv = argv
    finally:
        jclip_model.CONFIGS["vit_b16"] = saved_cfg
        os.environ.pop("ARP_TPU_CHECKPOINT_DIR", None)

    # JAX's eval restore (train/eval.py): CheckpointManager.restore of the latest step into a template
    template = policy_train_state(jax_policy(11)[1])
    restored, _ = jckpt.CheckpointManager(str(root / "policy")).restore(jax.device_get(template))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    want = np.asarray(jmodel.apply({"params": restored.params}, jbatch, deterministic=True)["action_pred"])
    return dict(root=root, read=read, arrays=dict(np.load(root / "port_read.npz")), want_action_pred=want,
                jmodel=jmodel, params=params, sources=sources)


# --- the blocked read -------------------------------------------------------------------------------


def test_the_read_loads_nothing_of_jax(jax_written):
    assert jax_written["read"]["blocked_modules_loaded"] == []


@pytest.mark.parametrize("leaf", ["params/w", "params/b", "params/n", "opt/0", "opt/1/mu"])
def test_every_leaf_is_bit_equal(jax_written, leaf):
    want = _flat({**MIXED, "params": {**MIXED["params"], "b": np.asarray(
        jnp.asarray(MIXED["params"]["b"], jnp.bfloat16))}})[tuple(leaf.split("/"))]
    want = np.asarray(want)
    dtype = jax_written["read"]["mixed_dtypes"][leaf]
    assert dtype == want.dtype.name
    got = jax_written["arrays"][leaf]
    if dtype == "bfloat16":  # the port left it as its bits
        np.testing.assert_array_equal(got, want.view(np.uint16))
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_sequences_metadata_and_bf16_bits(jax_written):
    read = jax_written["read"]
    assert read["mixed_sequence"] and read["mixed_meta"] == {"epoch": 2}
    assert read["bf16_bits_kept"]


def test_orbax_leaves_match_orbax_s_own_restore(jax_written):
    """In this process, the reader against orbax's template-free restore of the same step: the same leaves."""
    root = jax_written["root"]
    got, _ = tckpt.restore_orbax_params(str(root / "policy"))
    want, _ = jckpt.CheckpointManager(str(root / "policy")).restore_params()
    got, want = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, dict(want)))
    assert set(got) == set(want) and len(got) > 10
    for path, value in want.items():
        assert got[path].dtype == value.dtype and np.array_equal(got[path], value), path


@pytest.mark.parametrize("layout", ["policy", "legacy"])
def test_eval_restore_gives_jax_s_action_pred(jax_written, layout):
    got = jax_written["arrays"][f"{layout}_action_pred"]
    np.testing.assert_allclose(got, jax_written["want_action_pred"], atol=ATOL, rtol=0)
    if layout == "policy":
        assert jax_written["read"]["policy_meta"] == {"epoch": 1, "step": 3}


@pytest.mark.parametrize("source", ADAPTER_SOURCES)
def test_clip_ft_rewards_match_jax_s_labeler(jax_written, source):
    """F7 (the two pickles) and 10b (the orbax directory): the labeler's --model_ckpt_dir on JAX's files."""
    root = jax_written["root"]
    with h5py.File(root / f"port_{source}.hdf5", "r") as a, h5py.File(root / f"jax_{source}.hdf5", "r") as b:
        for key in ("ob_clip_ft_reward", "ob_clip_ft_pos_rtg"):
            assert a[key].shape == b[key].shape == (12, 2)
            assert np.abs(a[key][:] - b[key][:]).mean() <= MAE * (6 if "rtg" in key else 1), key


# --- the directory helpers and the readers, in this process ------------------------------------------


def test_directory_helpers(jax_written, tmp_path):
    root = jax_written["root"]
    assert tckpt.orbax_steps(str(root / "policy")) == [3] and tckpt.latest_orbax_step(str(root / "policy")) == 3
    assert tckpt.orbax_best_state_dir(str(root / "policy")) == str(root / "policy" / "best" / "v3" / "state")
    assert tckpt.orbax_best_state_dir(str(root / "legacy")) == str(root / "legacy" / "best" / "state")
    assert tckpt.orbax_steps(str(tmp_path)) == [] and tckpt.latest_orbax_step(str(tmp_path / "absent")) is None
    assert tckpt.orbax_best_state_dir(str(tmp_path)) is None
    _, meta = tckpt.load_orbax_item(tckpt.orbax_best_state_dir(str(root / "policy")))
    assert meta == {"epoch": 1, "step": 3, "score": 0.5}
    with pytest.raises(FileNotFoundError, match="no orbax checkpoint step"):
        tckpt.restore_orbax_params(str(tmp_path))


def test_a_missing_tensorstore_is_named(jax_written, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore") as info:
        tckpt.load_orbax_item(str(jax_written["root"] / "mixed" / "4" / "state"))
    assert str(jax_written["root"]) in str(info.value)


def test_eval_restore_prefers_the_port_s_own_files(jax_written, tmp_path):
    """The port's step_<n>.pt keeps its place beside JAX's steps."""
    from arp_tpu_torch.train.eval import restore_policy_state

    ckpt = tmp_path / "both"
    shutil.copytree(jax_written["root"] / "policy", ckpt)
    model = port_policy(tconvert.flax_policy_to_torch(jax_written["params"]))
    tckpt.save_policy_state(str(ckpt), 9, model)
    state, meta = restore_policy_state(str(ckpt))
    assert meta["step"] == 9


def test_server_reloads_a_jax_step_written_after_the_first_load(jax_written, tmp_path):
    ckpt = tmp_path / "serving"
    shutil.copytree(jax_written["root"] / "policy", ckpt)
    assert tserve.has_checkpoint(str(ckpt)) and not tserve.has_checkpoint(str(tmp_path / "empty"))
    (tmp_path / "empty").mkdir()
    assert not tserve.has_checkpoint(str(tmp_path / "empty"))  # an empty directory is still no checkpoint
    batch = policy_batch(4)
    model = port_policy(tconvert.flax_policy_to_torch(jax_policy(20)[1]))
    policy_fn, load_latest = tserve.reloadable_policy(model, str(ckpt))
    assert load_latest() == {"step": 3}
    first = policy_fn(batch)
    _, new_params = jax_policy(21)
    mngr = jckpt.CheckpointManager(str(ckpt))
    mngr.save(7, policy_train_state(new_params), {"epoch": 2}, wait=True)
    mngr.close()
    assert load_latest() == {"step": 7}
    want = port_policy(tconvert.flax_policy_to_torch(new_params))
    with torch.no_grad():
        np.testing.assert_array_equal(policy_fn(batch).numpy(), want.greedy_action(batch).numpy())
    assert first.shape == policy_fn(batch).shape
    with pytest.raises(FileNotFoundError, match="no step_<n>.pt or orbax checkpoint step"):
        tserve.reloadable_policy(model, str(tmp_path / "empty"))[1]()


# --- the resuming CLIs refuse a JAX-only directory ---------------------------------------------------


def _cli(name):
    from arp_tpu_torch.collect import train_ppg
    from arp_tpu_torch.finetune import train as tft
    from arp_tpu_torch.train import main as tmain
    from arp_tpu_torch.train import pretrain_m3ae

    return {"trainer": tmain, "finetune": tft, "pretrain_m3ae": pretrain_m3ae, "train_ppg": train_ppg}[name].main


@pytest.mark.parametrize("cli", ["trainer", "finetune", "pretrain_m3ae", "train_ppg"])
def test_resuming_clis_refuse_a_jax_only_directory(jax_written, tmp_path, cli):
    ckpt = tmp_path / "jax_run"
    shutil.copytree(jax_written["root"] / "policy", ckpt)
    before = sorted(os.listdir(ckpt))
    with pytest.raises(RuntimeError, match="resuming a JAX run is not supported") as info:
        _cli(cli)([f"--checkpoint_dir={ckpt}", "--device=cpu"])
    assert "step 3" in str(info.value)
    assert sorted(os.listdir(ckpt)) == before  # nothing written beside JAX's steps


def test_checkpoint_manager_refuses_only_a_jax_only_directory(jax_written, tmp_path):
    ckpt = tmp_path / "jax_best_only"
    shutil.copytree(jax_written["root"] / "legacy", ckpt)
    with pytest.raises(RuntimeError, match="best"):
        tckpt.CheckpointManager(str(ckpt))
    tckpt.save_policy_state(str(ckpt), 1, port_policy(tconvert.flax_policy_to_torch(jax_written["params"])))
    assert tckpt.CheckpointManager(str(ckpt)).latest_step() == 1  # the port's own files beside it: resumable
    tckpt.CheckpointManager(str(tmp_path / "fresh"))  # an empty or new directory: a fresh run
