"""The port's PPG CLIs: train_ppg -> eval_ppg -> collect, and their pickles crossing with the JAX package's.

As tests/test_collect.py::test_train_ppg_and_collect_clis: the CLIs run in subprocesses on the CPU
(``--device=cpu``).  The port's ``--checkpoint_path`` pickle is read by JAX's ``eval_ppg.evaluate``
and JAX's pickle by the port's, with the same greedy metrics; ``collect`` with one pickle writes the
JAX CLI's HDF5 datasets; ``--mesh_dp=2`` in one process fails the mesh's assertion.
"""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.cli_env import make_cli_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(module, args, env=None):
    out = subprocess.run([sys.executable, "-m", module, *args], env=env or make_cli_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ppg")
    ckpt = str(tmp / "ppg.pkl")
    _run("arp_tpu_torch.collect.train_ppg", [
        "--device=cpu", "--fake_env=True", "--num_envs=2", "--segment_length=8", "--total_iterations=2",
        "--n_pi=2", "--n_aux_epochs=1", "--episode_length=10", f"--checkpoint_path={ckpt}",
        f"--logging.output_dir={tmp / 'log'}"])
    return tmp, ckpt


COLLECT_ARGS = ["--fake_env=True", "--game_name=coinrun", "--num_episodes=2", "--num_frames=4", "--episode_length=30",
                "--enable_filter=False", "--num_levels=10", "--start_level=0", "--seed=3"]
DATASET = "coinrun_hard_level0to10_num2_frame4_unfiltered"


def test_train_ppg_eval_ppg_and_collect_clis(trained):
    tmp, ckpt = trained
    from arp_tpu_torch.checkpoint import load_pickle

    data = load_pickle(ckpt)
    assert set(data) == {"params", "history"} and len(data["history"]) == 2 and "kl" in data["history"][1]
    assert data["params"]["pi_enc"]["stack0_firstconv"]["kernel"].shape == (3, 3, 3, 16)
    out = _run("arp_tpu_torch.collect.eval_ppg", ["--device=cpu", f"--checkpoint={ckpt}", "--fake_env",
                                                   "--num_episodes=2", "--num_envs=2"])
    assert "mean_return" in out.stdout
    out = _run("arp_tpu_torch.collect.collect", COLLECT_ARGS + ["--device=cpu", f"--model_path={ckpt}",
                                                                 f"--out_dir={tmp / 'port'}"])
    assert "recorded 2 episodes" in out.stdout


def _fake_envs(n, jax_pkg):
    if jax_pkg:
        from arp_tpu.envs.fake import FakeProcgen
    else:
        from arp_tpu_torch.envs.fake import FakeProcgen
    return [FakeProcgen("coinrun", {"episode_length": 12}) for _ in range(n)]


def test_pickles_cross_between_the_packages(trained, tmp_path):
    """The port's pickle through JAX's evaluate, JAX's through the port's: the same greedy returns."""
    from arp_tpu.checkpoint import load_pickle as j_load_pickle
    from arp_tpu.checkpoint import save_pickle as j_save_pickle
    from arp_tpu.collect.eval_ppg import evaluate as j_evaluate
    from arp_tpu.collect.ppg import PhasicValueModel as JModel
    from arp_tpu_torch.checkpoint import load_pickle
    from arp_tpu_torch.collect.eval_ppg import evaluate, params_of

    _, ckpt = trained
    port_params = j_load_pickle(ckpt)["params"]  # the JAX package reads the port's file
    params = JModel(num_actions=15).init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)))["params"]
    jax_ckpt = str(tmp_path / "jax.pkl")
    j_save_pickle({"params": jax.device_get(params), "history": []}, jax_ckpt)
    for name, (j_params, t_params) in {"port's": (port_params, params_of(load_pickle(ckpt))),
                                       "jax's": (j_load_pickle(jax_ckpt)["params"],
                                                 params_of(load_pickle(jax_ckpt)))}.items():
        want = j_evaluate(j_params, _fake_envs(2, True), num_episodes=3)
        got = evaluate(t_params, _fake_envs(2, False), num_episodes=3, device="cpu")
        assert got == want, name


def test_collect_writes_the_jax_cli_s_datasets(trained, tmp_path):
    """The JAX CLI with the port's pickle, and the port's CLI (its run above, the same flags): the same demos."""
    tmp, ckpt = trained
    if not (tmp / "port" / DATASET).is_dir():
        _run("arp_tpu_torch.collect.collect", COLLECT_ARGS + ["--device=cpu", f"--model_path={ckpt}",
                                                             f"--out_dir={tmp / 'port'}"])
    _run("arp_tpu.collect.collect", COLLECT_ARGS + [f"--model_path={ckpt}", f"--out_dir={tmp_path / 'jax'}"])
    with h5py.File(tmp_path / "jax" / DATASET / "data_train.hdf5", "r") as j, \
            h5py.File(tmp / "port" / DATASET / "data_train.hdf5", "r") as t:
        assert set(j) == set(t) and {"ob", "act", "done", "reward"} <= set(t)
        for k in j:
            np.testing.assert_array_equal(t[k][...], j[k][...], err_msg=k)
    assert sorted(os.listdir(tmp_path / "jax" / DATASET)) == sorted(os.listdir(tmp / "port" / DATASET))


def test_mesh_dp_raises_and_names_item_12(tmp_path):
    from arp_tpu_torch.collect import train_ppg

    # item 12a ported --mesh_dp as torchrun's world: in one process it fails JAX's mesh assertion
    with pytest.raises(AssertionError, match="mesh 2x1x1x1 != 1 devices"):
        train_ppg.main(["--device=cpu", "--mesh_dp=2", f"--logging.output_dir={tmp_path}"])


def test_eval_reads_a_train_state_pickle_and_a_raw_tree(trained, tmp_path):
    """eval_ppg's reader: a TrainState pickle (read without flax) and a raw params tree give the trained params."""
    from arp_tpu_torch import _pickle_compat
    from arp_tpu_torch.checkpoint import load_pickle, save_pickle
    from arp_tpu_torch.collect.eval_ppg import params_of

    _, ckpt = trained
    params = load_pickle(ckpt)["params"]
    save_pickle(_pickle_compat.ReferenceTrainState(step=3, params=params), str(tmp_path / "state.pkl"))
    save_pickle(params, str(tmp_path / "raw.pkl"))
    for name in ("state.pkl", "raw.pkl"):
        got = params_of(load_pickle(str(tmp_path / name)))
        assert np.array_equal(got["pi_head"]["kernel"], params["pi_head"]["kernel"]), name
