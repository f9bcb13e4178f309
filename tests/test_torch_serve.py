"""The port's policy server on the CPU (``--device cpu``): the cases of tests/test_serve.py
that concern the policy server, over real HTTP, and the server against the JAX package's on
the same weights and observations."""

import json
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from arp_tpu.models.policy import ARPDT as JARPDT
from arp_tpu.serve import PolicyServer as JPolicyServer
from arp_tpu_torch import serve as S
from arp_tpu_torch.models.policy import ARPDT, flax_policy_to_torch
from arp_tpu_torch.ops.augment import make_eval_transform

@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models: more intra-op threads only fight the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


CFG = dict(model_type="vit_debug", transfer_type="none", emb_dim=32, depth=2, num_heads=4, mlp_ratio=2,
           use_discrete_action=True, num_ensembles=2)
DUMMY = {
    "image": {"ob": np.zeros((1, 2, 32, 32, 3), np.float32)},
    "rtg": {"ob": np.zeros((1, 2, 1), np.float32)},
    "action": np.zeros((1, 2), np.int32),
    "instruct": None,
    "text_padding_mask": None,
}


def scale(x):
    return np.asarray(x, np.float32) / 255.0


def make_model(seed=0, **over):
    torch.manual_seed(seed)
    model = ARPDT(dict(CFG, **over), num_actions=15, patch_dim=16).eval()
    with torch.no_grad():
        model(DUMMY, deterministic=True)
    return model


def policy_fn_of(model):
    def policy_fn(inputs):
        with torch.inference_mode():
            return model.greedy_action(inputs)

    return policy_fn


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def server_url():
    server = S.PolicyServer(policy_fn=policy_fn_of(make_model()), transform_obs_fn=scale, window_size=4)
    httpd = server.make_http_server("127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()


def test_serve_session_lifecycle(server_url):
    assert _get(server_url + "/v1/health")["status"] == "ok"
    sid = _post(server_url + "/v1/session", {"return_to_go": 100.0, "scale": 100.0})["session_id"]
    obs = np.random.default_rng(0).integers(0, 256, size=(32, 32, 3)).tolist()
    r1 = _post(server_url + "/v1/act", {"session_id": sid, "observation": obs})
    assert 0 <= r1["action"] < 15 and r1["rtg"] == 100.0
    r2 = _post(server_url + "/v1/act", {"session_id": sid, "observation": obs, "reward": 10.0})
    assert abs(r2["rtg"] - 90.0) < 1e-5  # a reward decrements the return-to-go
    for _ in range(5):  # the window keeps rolling past window_size
        r = _post(server_url + "/v1/act", {"session_id": sid, "observation": obs, "reward": 0.0})
    assert 0 <= r["action"] < 15
    assert _get(server_url + "/v1/health")["sessions"] == 1
    _post(server_url + "/v1/session/close", {"session_id": sid})
    assert _get(server_url + "/v1/health")["sessions"] == 0


@pytest.mark.parametrize("path,payload,code,message", [
    ("/v1/act", {"observation": [[0]]}, 400, "missing field"),
    ("/v1/act", {"session_id": "deadbeef", "observation": np.zeros((32, 32, 3), np.uint8).tolist()}, 410,
     "unknown or expired session"),
    ("/v1/reload", {}, 400, "without a reload_fn"),
    ("/v1/nowhere", {}, 404, "not found"),
])
def test_serve_error_codes(server_url, path, payload, code, message):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(server_url + path, payload)
    assert exc.value.code == code and message in json.loads(exc.value.read())["error"]


def test_serve_a_failing_forward_is_500(server_url):
    sid = _post(server_url + "/v1/session", {})["session_id"]
    with pytest.raises(urllib.error.HTTPError) as exc:  # 8 x 8 does not cut into 16 x 16 patches
        _post(server_url + "/v1/act", {"session_id": sid, "observation": np.zeros((8, 8, 3), np.uint8).tolist()})
    assert exc.value.code == 500
    _post(server_url + "/v1/session/close", {"session_id": sid})


def test_session_window_and_inputs():
    s = S.PolicySession(window_size=2, return_to_go=10.0, scale=10.0)
    for t in range(3):
        s.push(np.full((4, 4, 3), t, np.float32), 1.0 if t else None)
        inputs = s.inputs()
        s.record_action(t + 1)
    assert inputs["image"]["ob"].shape == (1, 2, 4, 4, 3) and inputs["image"]["ob"][0, :, 0, 0, 0].tolist() == [1.0, 2.0]
    np.testing.assert_allclose(inputs["rtg"]["ob"][0, :, 0], [0.9, 0.8], atol=1e-6)
    assert inputs["action"].tolist() == [[2, 0]]  # the action of the frame still in the window, then the open slot
    assert inputs["instruct"] is None


def test_tree_helpers_pass_none_through():
    a = {"image": {"ob": np.ones((1, 2))}, "action": np.zeros((1, 3)), "instruct": None}
    assert [leaf.shape for leaf in S.tree_leaves(a)] == [(1, 2), (1, 3)]
    out = S.tree_map(lambda *xs: np.concatenate(xs, 0), a, a, a)
    assert out["image"]["ob"].shape == (3, 2) and out["action"].shape == (3, 3) and out["instruct"] is None
    assert S._MicroBatcher._signature(a) == ((1, 2), (1, 3))


def test_policy_serve_micro_batching():
    """max_batch > 1 coalesces concurrent sessions' /act calls into fewer forwards AND returns
    exactly the actions the unbatched server gives."""
    kw = dict(policy_fn=policy_fn_of(make_model()), transform_obs_fn=scale, window_size=4)
    plain = S.PolicyServer(**kw)
    batched = S.PolicyServer(**kw, max_batch=8, batch_wait_ms=200.0)  # a generous window: determinism under load
    rng = np.random.default_rng(7)
    n_sessions, n_steps = 6, 3
    obs = rng.integers(0, 256, (n_sessions, n_steps, 32, 32, 3), np.uint8)
    step_barrier = threading.Barrier(n_sessions)

    def run_episode(server, s, barrier=None):
        sid = server.create_session({"return_to_go": 10.0, "scale": 10.0})["session_id"]
        acts = []
        for t in range(n_steps):
            if barrier is not None:
                barrier.wait()  # all sessions' step-t requests leave together
            out = server.act({"session_id": sid, "observation": obs[s, t].tolist(), "reward": 0.1 if t else None})
            acts.append(out["action"])
        return acts

    want = [run_episode(plain, s) for s in range(n_sessions)]
    with ThreadPoolExecutor(n_sessions) as pool:
        got = list(pool.map(lambda s: run_episode(batched, s, step_barrier), range(n_sessions)))
    assert got == want
    total = n_sessions * n_steps
    assert batched._batcher.dispatches < total, f"no coalescing: {batched._batcher.dispatches} dispatches"
    stats = batched.health()["batching"]
    assert stats["batched_requests"] == total and stats["mean_batch_occupancy"] > 1.0


def test_micro_batcher_error_reaches_every_waiting_handler():
    def failing(inputs):
        raise ValueError("boom")

    batcher = S._MicroBatcher(failing, max_batch=4, max_wait_ms=50.0)
    with ThreadPoolExecutor(3) as pool:
        futures = [pool.submit(batcher.submit, {"action": np.zeros((1, 2))}) for _ in range(3)]
        for f in futures:
            with pytest.raises(ValueError, match="boom"):
                f.result(timeout=30)


def test_policy_serve_warmup_covers_all_live_signatures():
    """warmup() runs exactly the signature set live traffic hits: every (window ramp-up length)
    x (micro-batcher bucket) shape seen by a real session run was already issued by warmup."""
    fn = policy_fn_of(make_model())
    seen, phase = [], {"warmup": True}

    def recording(inputs):
        sig = tuple((np.shape(leaf), np.asarray(leaf).dtype.str) for leaf in S.tree_leaves(inputs))
        seen.append(("warmup" if phase["warmup"] else "live", sig))
        return fn(inputs)

    server = S.PolicyServer(policy_fn=recording, transform_obs_fn=scale, window_size=4, max_batch=4, batch_wait_ms=1.0)
    warmed = server.warmup(scale(np.zeros((32, 32, 3), np.uint8)))
    assert warmed == [(w, b) for w in (1, 2, 3, 4) for b in (1, 2, 4)]
    phase["warmup"] = False
    rng = np.random.default_rng(0)
    sid = server.create_session({"return_to_go": 10.0, "scale": 10.0})["session_id"]
    for t in range(6):  # ramp-up, then the steady state
        server.act({"session_id": sid, "observation": rng.integers(0, 256, (32, 32, 3), np.uint8).tolist(),
                    "reward": 0.1 if t else None})
    sids = [server.create_session({})["session_id"] for _ in range(3)]
    with ThreadPoolExecutor(3) as pool:  # a concurrent burst: a bucket above 1
        list(pool.map(lambda s: server.act({"session_id": s, "observation": np.zeros((32, 32, 3), np.uint8).tolist()}), sids))
    warm = {sig for ph, sig in seen if ph == "warmup"}
    live = {sig for ph, sig in seen if ph == "live"}
    assert live and live <= warm, f"unwarmed live signatures: {live - warm}"


def test_server_gives_the_jax_servers_actions_and_rtg():
    """The same weights (through the bridge), observations and rewards through both packages'
    servers: the same actions, step by step, while the window ramps up and rolls."""
    jmodel = JARPDT(config_updates=dict(CFG), num_actions=15, patch_dim=16)
    rngs = {"params": jax.random.PRNGKey(3), "noise": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)}
    params = jmodel.init(rngs, DUMMY, deterministic=True)["params"]
    tmodel = make_model()
    tmodel.load_trained_state_dict(flax_policy_to_torch(jax.device_get(params)))
    jserver = JPolicyServer(policy_fn=lambda i: jmodel.apply({"params": params}, i, method=jmodel.greedy_action),
                            transform_obs_fn=scale, window_size=3)
    tserver = S.PolicyServer(policy_fn=policy_fn_of(tmodel), transform_obs_fn=scale, window_size=3)
    jsid, tsid = jserver.create_session({})["session_id"], tserver.create_session({})["session_id"]
    rng = np.random.default_rng(5)
    for t in range(6):
        body = {"observation": rng.integers(0, 256, (32, 32, 3), np.uint8).tolist(), "reward": float(t) if t else None}
        assert tserver.act({"session_id": tsid, **body}) == jserver.act({"session_id": jsid, **body})


def test_save_and_load_policy_state(tmp_path):
    model = make_model(seed=4)
    assert S.latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError, match="no step_<n>.pt"):
        S.load_policy_state(str(tmp_path))
    S.save_policy_state(str(tmp_path), 3, model)
    S.save_policy_state(str(tmp_path), 12, make_model(seed=5))
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    assert S.latest_step(str(tmp_path)) == 12 and not list(tmp_path.glob("*.tmp"))
    state, meta = S.load_policy_state(str(tmp_path))
    assert meta == {"step": 12} and set(state) == set(model.trained_state_dict())
    assert not torch.equal(state["patch_emb.weight"], model.patch_emb.weight)


def _start_main(argv):
    started = {"evt": threading.Event()}
    orig_argv, orig_serve = sys.argv, S.ThreadingHTTPServer.serve_forever

    def capture(self, *a, **k):
        started["port"], started["server"] = self.server_address[1], self
        started["evt"].set()
        orig_serve(self, *a, **k)

    sys.argv, S.ThreadingHTTPServer.serve_forever = argv, capture
    try:
        threading.Thread(target=S.main, daemon=True).start()
        assert started["evt"].wait(300), "server did not start"
    finally:
        sys.argv, S.ThreadingHTTPServer.serve_forever = orig_argv, orig_serve
    return started


def test_policy_serve_hot_reload(tmp_path):
    """POST /v1/reload picks up the latest checkpoint without a restart: the real CLI main() on
    the CPU, a checkpoint saved AFTER startup, then the served action is the new weights' and
    /v1/health reports the step."""
    ckpt_dir = str(tmp_path / "ckpt")
    started = _start_main(["serve", "--checkpoint_dir", ckpt_dir, "--allow_random_init", "--port", "0",
                           "--window_size", "2", "--image_size", "32", "--emb_dim", "32", "--depth", "2",
                           "--num_heads", "4", "--model_type", "vit_debug", "--device", "cpu", "--warmup",
                           "--max_batch", "2"])
    url = f"http://127.0.0.1:{started['port']}"
    try:
        assert "checkpoint" not in _get(url + "/v1/health")
        obs = np.full((32, 32, 3), 128, np.uint8)
        sid = _post(url + "/v1/session", {"return_to_go": 10.0, "scale": 10.0})["session_id"]
        _post(url + "/v1/act", {"session_id": sid, "observation": obs.tolist()})

        candidates = []
        for seed in range(9, 14):  # weights whose action differs from some other candidate's
            model = make_model(seed=seed, num_ensembles=5, mlp_ratio=4)
            tobs = make_eval_transform(image_size=32, device="cpu")(obs).numpy()
            inputs = {"image": {"ob": tobs[None, None]}, "rtg": {"ob": np.ones((1, 1, 1), np.float32)},
                      "action": np.zeros((1, 1), np.int32), "instruct": None, "text_padding_mask": None}
            with torch.no_grad():
                candidates.append((model, int(model.greedy_action(inputs)[0])))
        assert len({a for _, a in candidates}) > 1
        for step, (model, want) in enumerate(candidates, start=7):
            S.save_policy_state(ckpt_dir, step, model)
            out = _post(url + "/v1/reload", {})
            assert out == {"status": "reloaded", "step": step}
            assert _get(url + "/v1/health")["checkpoint"]["step"] == step
            sid = _post(url + "/v1/session", {"return_to_go": 10.0, "scale": 10.0})["session_id"]
            got = _post(url + "/v1/act", {"session_id": sid, "observation": obs.tolist()})
            assert got["action"] == want, (step, got, want)
    finally:
        started["server"].shutdown()


def test_main_without_a_checkpoint_is_an_error(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", "--checkpoint_dir", str(tmp_path), "--device", "cpu", "--image_size", "32",
                                      "--emb_dim", "32", "--num_heads", "4"])
    with pytest.raises(FileNotFoundError, match="no step_<n>.pt"):
        S.main()


def test_main_asks_for_cuda_unless_told_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setattr(sys, "argv", ["serve", "--checkpoint_dir", str(tmp_path), "--allow_random_init"])
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        S.main()


@pytest.mark.parametrize("flags", [[], ["--allow_random_init"]], ids=["plain", "allow_random_init"])
def test_main_frozen_tower_needs_its_file(flags, tmp_path, monkeypatch):
    """--allow_random_init covers a missing policy checkpoint, never a missing frozen tower."""
    monkeypatch.setenv("ARP_TPU_CHECKPOINT_DIR", str(tmp_path / "towers"))
    monkeypatch.setattr(sys, "argv", ["serve", "--checkpoint_dir", str(tmp_path), "--device", "cpu",
                                      "--transfer_type", "m3ae_vit_b16", *flags])
    with pytest.raises(FileNotFoundError, match="m3ae checkpoint not found"):
        S.main()
