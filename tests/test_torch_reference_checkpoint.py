"""Reference-format checkpoints between the two packages, and the CLIP tower's OpenAI checkpoint (F5).

* A pickle written by arp_tpu's ``save_reference_checkpoint`` is read by the port without flax,
  optax, jax or cloudpickle; the port's policy on those params gives action_pred within 1e-5 of
  the Flax policy on the params arp_tpu's loader reads from the same file.
* A pickle written by the port's ``save_reference_checkpoint`` is read by arp_tpu's loader: every
  param leaf equal (bit for bit) to the leaf of arp_tpu's own export, step and epoch equal, the
  output equal.
* The name mappers (``ensemble_mode`` collapses, the 5-member broadcast, the deep-head refusal)
  give arp_tpu's trees bit for bit, and raise where arp_tpu's raise.
* F5: a ``clip_*`` policy reads an OpenAI-layout ``.npy`` by name or by path, as arp_tpu's does;
  action_pred within 1e-5.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arp_tpu import checkpoint as jckpt
from arp_tpu.models.clip import CLIP as JCLIP
from arp_tpu.models.clip import model as jclip_mod
from arp_tpu.models.policy import convert as jconvert
from arp_tpu.models.policy import models as jpol
from arp_tpu_torch import checkpoint as tckpt
from arp_tpu_torch.models.clip import CLIP as TCLIP
from arp_tpu_torch.models.clip import model as tclip_mod
from arp_tpu_torch.models.policy import convert as tconvert
from arp_tpu_torch.models.policy import models as tpol
from test_torch_finetune_engine import openai_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
PATCH = 16
CFG = dict(model_type="vit_debug", transfer_type="none", emb_dim=32, depth=2, num_heads=4, mlp_ratio=2,
           use_discrete_action=True, num_ensembles=5)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_batch(seed, with_rtg=True, img=32):
    rng = np.random.default_rng(seed)
    batch = {"image": {"ob": rng.normal(size=(2, 2, img, img, 3)).astype(np.float32)},
             "action": rng.integers(0, 15, size=(2, 2)).astype(np.int32), "instruct": None, "text_padding_mask": None}
    if with_rtg:
        batch["rtg"] = {"ob": rng.normal(size=(2, 2, 1)).astype(np.float32)}
    return batch


def _jbatch(batch):
    return jax.tree_util.tree_map(jnp.asarray, batch)


def tie_ensembles(params):
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(params))
    for path, v in flat.items():
        if "heads" in path:
            flat[path] = jnp.broadcast_to(v[:1], v.shape)
    return flax.traverse_util.unflatten_dict(flat)


def jax_policy(cls, cfg, seed, tied=True):
    """A Flax policy and seeded params (moved off the init, ensemble heads tied unless asked)."""
    model = getattr(jpol, cls)(config_updates=cfg, num_actions=15, patch_dim=PATCH)
    rngs = {"params": jax.random.PRNGKey(seed), "noise": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    params = model.init(rngs, _jbatch(make_batch(0, with_rtg=cls == "ARPDT")), deterministic=True)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(np.float32),
                                    flax.core.unfreeze(params))
    return model, (tie_ensembles(params) if tied else params)


def port_policy(cls, cfg, state, batch):
    model = getattr(tpol, cls)(cfg, num_actions=15, patch_dim=PATCH).eval()
    with torch.no_grad():
        model(batch, deterministic=True)  # the lazy layers take their shapes
        model.load_trained_state_dict(state)
    return model


def leaves(tree):
    return {path: np.asarray(v) for path, v in flax.traverse_util.flatten_dict(flax.core.unfreeze(tree)).items()}


def assert_trees_equal(got, want):
    got, want = leaves(got), leaves(want)
    assert set(got) == set(want)
    for path in want:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg="/".join(path))


# --- a JAX-written file read by the port --------------------------------------------------------


@pytest.mark.parametrize("cls", ["ARPDT", "BC"])
def test_jax_written_checkpoint_loads_in_the_port(tmp_path, cls):
    jmodel, params = jax_policy(cls, CFG, 3)
    path = str(tmp_path / "model.pkl")
    jckpt.save_reference_checkpoint(path, {"params": params}, step=7, epoch=3, variant={"model_type": "vit_debug"})
    batch = make_batch(1, with_rtg=cls == "ARPDT")

    want_data = jckpt.load_reference_checkpoint(path)
    want = jmodel.apply({"params": want_data["state"].params}, _jbatch(batch), deterministic=True)
    data = tckpt.load_reference_checkpoint(path)
    assert (data["step"], data["epoch"], data["variant"]) == (7, 3, {"model_type": "vit_debug"})
    assert_trees_equal(data["state"].params, want_data["state"].params)
    with torch.no_grad():
        got = port_policy(cls, CFG, tckpt.reference_policy_state(data), batch)(batch, deterministic=True)
    np.testing.assert_allclose(got["action_pred"].numpy(), np.asarray(want["action_pred"]), atol=ATOL, rtol=0)
    if cls == "ARPDT":
        np.testing.assert_allclose(got["return_pred"].numpy(), np.asarray(want["return_pred"]), atol=ATOL, rtol=0)


def test_the_raw_file_keeps_its_optimizer_as_placeholders(tmp_path):
    _, params = jax_policy("ARPDT", CFG, 4)
    path = str(tmp_path / "model.pkl")
    jckpt.save_reference_checkpoint(path, {"params": params}, step=2)
    state = tckpt.load_pickle(path)["state"]
    assert isinstance(state, tckpt._pickle_compat.ReferenceTrainState) and state.step == 0
    assert "action_outputs_0" in state.params and isinstance(state.params["policy"]["Block_0"], dict)
    assert isinstance(state.tx, tckpt._pickle_compat.OpaqueReference)
    with pytest.raises(TypeError, match="placeholder"):
        state.tx(1)


def test_jax_written_file_loads_with_the_jax_stack_blocked(tmp_path):
    """In a fresh process where flax, optax, jax, jaxlib and cloudpickle cannot be imported."""
    _, params = jax_policy("ARPDT", CFG, 5)
    path = str(tmp_path / "model.pkl")
    jckpt.save_reference_checkpoint(path, {"params": params}, step=11, epoch=1)
    want = float(np.asarray(jckpt.load_reference_checkpoint(path)["state"].params["policy"]["norm"]["scale"]).sum())
    script = textwrap.dedent(f"""
        import sys
        for name in ("flax", "optax", "jax", "jaxlib", "cloudpickle", "arp_tpu"):
            sys.modules[name] = None
        from arp_tpu_torch.checkpoint import load_reference_checkpoint, reference_policy_state
        data = load_reference_checkpoint({path!r})
        state = reference_policy_state(data)
        assert data["step"] == 11 and data["epoch"] == 1
        print(repr(float(data["state"].params["policy"]["norm"]["scale"].sum())), len(state))
        bad = [m for m in sys.modules if m.split(".")[0] in ("flax", "optax", "jax", "jaxlib", "cloudpickle")
               and sys.modules[m] is not None]
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout
    total, n = out.stdout.split()
    assert float(total) == want and int(n) > 0


# --- a port-written file read by JAX --------------------------------------------------------------


def test_port_export_reads_in_jax_as_jax_export(tmp_path):
    jmodel, params = jax_policy("ARPDT", CFG, 6)
    batch = make_batch(2)
    state = tconvert.flax_policy_to_torch(params)
    model = port_policy("ARPDT", CFG, state, batch)
    jax_path, port_path = str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")
    jckpt.save_reference_checkpoint(jax_path, {"params": params}, step=9, epoch=2, variant={"a": 1})
    tckpt.save_reference_checkpoint(port_path, model.trained_state_dict(), step=9, epoch=2, variant={"a": 1})

    ours, theirs = jckpt.load_pickle(port_path), jckpt.load_pickle(jax_path)
    assert type(ours["state"]) is type(theirs["state"])  # a real flax TrainState once unpickled in JAX
    assert (ours["step"], ours["epoch"], ours["variant"]) == (theirs["step"], theirs["epoch"], theirs["variant"])
    assert int(ours["state"].step) == int(theirs["state"].step) == 0
    assert_trees_equal(ours["state"].params, theirs["state"].params)
    assert ours["state"].tx is None and ours["state"].opt_state is None  # no optax chain without optax
    loaded = jckpt.load_reference_checkpoint(port_path)
    got = jmodel.apply({"params": loaded["state"].params}, _jbatch(batch), deterministic=True)
    want = jmodel.apply({"params": jckpt.load_reference_checkpoint(jax_path)["state"].params}, _jbatch(batch),
                        deterministic=True)
    for key in ("action_pred", "return_pred"):
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    with torch.no_grad():
        mine = model(batch, deterministic=True)["action_pred"].numpy()
    np.testing.assert_allclose(mine, np.asarray(got["action_pred"]), atol=ATOL, rtol=0)


# --- the name mappers ------------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["require_tied", "first", "mean"])
def test_ensemble_modes_match_jax(mode):
    _, untied = jax_policy("ARPDT", dict(CFG, num_ensembles=3), 7, tied=False)
    _, tied = jax_policy("ARPDT", dict(CFG, num_ensembles=3), 7)
    source = untied if mode != "require_tied" else tied
    want = jconvert.export_reference_policy_params(source, ensemble_mode=mode)
    got = tconvert.export_reference_policy_params(leaves_tree(source), ensemble_mode=mode)
    assert_trees_equal(got, want)
    assert_trees_equal(tconvert.convert_reference_policy_params(got, num_ensembles=3),
                       jconvert.convert_reference_policy_params(want, num_ensembles=3))
    if mode == "require_tied":
        for export in (jconvert.export_reference_policy_params, tconvert.export_reference_policy_params):
            with pytest.raises(ValueError, match="diverged"):
                export(leaves_tree(untied))
    with pytest.raises(ValueError, match="unknown ensemble_mode"):
        tconvert.export_reference_policy_params(leaves_tree(tied), ensemble_mode="median")


def leaves_tree(tree):
    """A Flax tree as plain nested dicts of numpy arrays (what the port converts)."""
    return flax.traverse_util.unflatten_dict(leaves(tree))


def test_deeper_heads_raise_as_in_jax():
    _, params = jax_policy("ARPDT", CFG, 8)
    ref = leaves_tree(jconvert.export_reference_policy_params(params))
    ref["action_outputs_0"]["layers_4"] = {"kernel": np.zeros((3, 3), np.float32)}
    for convert in (jconvert.convert_reference_policy_params, tconvert.convert_reference_policy_params):
        with pytest.raises(NotImplementedError, match="output_head_depth"):
            convert(ref)
    mine = leaves_tree(params)
    mine["action_outputs"]["heads"]["Dense_2"] = {"kernel": np.zeros((5, 3, 3), np.float32)}
    for export in (jconvert.export_reference_policy_params, tconvert.export_reference_policy_params):
        with pytest.raises(NotImplementedError, match="2-layer"):
            export(mine)


def test_three_ensembles_load_as_the_jax_loader_loads_them(tmp_path):
    """JAX's loader broadcasts the one head to 5 members whatever the model's count; so does the port's."""
    _, params = jax_policy("ARPDT", dict(CFG, num_ensembles=3), 9)
    path = str(tmp_path / "three.pkl")
    jckpt.save_reference_checkpoint(path, {"params": params})
    got, want = tckpt.load_reference_checkpoint(path), jckpt.load_reference_checkpoint(path)
    assert_trees_equal(got["state"].params, want["state"].params)
    assert got["state"].params["action_outputs"]["heads"]["Dense_0"]["kernel"].shape[0] == 5


def test_torch_policy_to_flax_inverts_the_bridge():
    _, params = jax_policy("ARPDT", dict(CFG, use_adapter=False), 10)
    state = tconvert.flax_policy_to_torch(params)
    back = tconvert.torch_policy_to_flax(state)
    assert_trees_equal(back, leaves_tree(params))
    again = tconvert.flax_policy_to_torch(back)
    assert set(again) == set(state) and all(torch.equal(again[k], state[k]) for k in state)


# --- F5: the CLIP tower's OpenAI checkpoint -------------------------------------------------------

TINY_CLIP = dict(embed_dim=16, vocab_size=97, vision_num_layers=1, vision_features=64, vision_patch_size=16,
                 text_features=16, text_num_heads=4, text_num_layers=1)


@pytest.mark.parametrize("by", ["name", "path"])
def test_clip_policy_reads_the_openai_checkpoint_as_jax_does(tmp_path, monkeypatch, by):
    np.save(tmp_path / "tiny_test.npy", openai_state_dict(TINY_CLIP, 32, seed=3), allow_pickle=True)
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setitem(jclip_mod.MODELS, "tiny_test", lambda **kw: JCLIP(**{**TINY_CLIP, **kw}))
    monkeypatch.setitem(tclip_mod.MODELS, "tiny_test", lambda **kw: TCLIP(**{**TINY_CLIP, "image_size": 32, **kw}))
    cfg = dict(CFG, transfer_type="clip_tiny_test", num_ensembles=3,
               clip_checkpoint_path="none" if by == "name" else str(tmp_path / "tiny_test.npy"))
    batch = make_batch(4)
    jmodel, params = jax_policy("ARPDT", cfg, 11, tied=False)
    want = jmodel.apply({"params": params}, _jbatch(batch), deterministic=True)
    got = port_policy("ARPDT", cfg, tconvert.flax_policy_to_torch(params), batch)
    with torch.no_grad():
        out = got(batch, deterministic=True)
    np.testing.assert_allclose(out["action_pred"].numpy(), np.asarray(want["action_pred"]), atol=ATOL, rtol=0)


def test_clip_policy_keeps_the_ports_own_state_dict_beside_it(tmp_path, monkeypatch):
    """An explicit .pt that torch.jit cannot open is the port's own state dict; a missing file raises."""
    monkeypatch.setitem(tclip_mod.MODELS, "tiny_test", lambda **kw: TCLIP(**{**TINY_CLIP, "image_size": 32, **kw}))
    torch.manual_seed(0)
    tower = TCLIP(**TINY_CLIP, image_size=32)
    torch.save(tower.state_dict(), tmp_path / "tower.pt")
    model = tpol.ARPDT(dict(CFG, transfer_type="clip_tiny_test", clip_checkpoint_path=str(tmp_path / "tower.pt")),
                       num_actions=15, patch_dim=PATCH)
    assert torch.equal(model.pt_model.visual.conv1.weight, tower.visual.conv1.weight)
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="tiny_test.npy"):
        tpol.ARPDT(dict(CFG, transfer_type="clip_tiny_test"), num_actions=15, patch_dim=PATCH)


def test_a_jax_pickle_of_plain_numpy_round_trips(tmp_path):
    """The reader keeps numpy scalars, dtypes and builtin containers; the writer's stream reads in plain pickle."""
    obj = {"a": np.arange(6, dtype=np.int64).reshape(2, 3), "b": [np.float32(1.5), (1, "x")], "c": {1, 2},
           "d": np.dtype("float16"), "e": slice(1, 5)}
    with open(tmp_path / "p.pkl", "wb") as f:
        pickle.dump(obj, f, protocol=5)
    got = tckpt.load_pickle(str(tmp_path / "p.pkl"))
    np.testing.assert_array_equal(got["a"], obj["a"])
    assert got["b"][0] == np.float32(1.5) and got["b"][1] == (1, "x") and got["c"] == {1, 2}
    assert got["d"] == np.dtype("float16") and got["e"] == slice(1, 5)
    tckpt.save_pickle(obj, str(tmp_path / "q.pkl"))
    with open(tmp_path / "q.pkl", "rb") as f:
        again = pickle.load(f)
    np.testing.assert_array_equal(again["a"], obj["a"])
