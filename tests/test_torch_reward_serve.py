"""The port's reward server against arp_tpu's ``RewardServer``, both behind real HTTP on 127.0.0.1.

On the same tiny CLIP weights every route answers alike in every wire format
(JSON lists, base64, raw bytes with a percent-encoded ``X-Text``): rewards
within 1e-5, the float32 engines' parity bound of
tests/test_torch_reward_engine.py; the same 400s and 404s for the same faulty
requests (the raw body's byte count among them); the same LRU keys, in the same
order, under the same bound; the same health fields; and after ``warmup`` under
``fast_int8`` the same int8 activation scales, within two bf16 ulps
(tests/test_torch_vit_infer.py's calibration bound).  The CLI's flags reach the
engine and ``--warmup_frames`` reads only the windows it needs.
"""

import base64
import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import h5py
import jax
import numpy as np
import pytest

from arp_tpu.reward.serve import RewardServer as JServer
from arp_tpu.testing import TINY_CLIP_CFG, TINY_CLIP_IMG_SIZE, make_tiny_clip_engine
from arp_tpu_torch.models.clip import CLIP
from arp_tpu_torch.models.clip.tokenizer import Char97Tokenizer
from arp_tpu_torch.reward import engine as tengine
from arp_tpu_torch.reward import serve as tserve
from arp_tpu_torch.reward.engine import ClipRewardEngine

RNG = np.random.default_rng(0)
FRAMES = RNG.integers(0, 256, size=(5, 40, 40, 3), dtype=np.uint8)
GOAL = RNG.integers(0, 256, size=(40, 40, 3), dtype=np.uint8)


def _port_engine(jax_engine, **kwargs):
    return ClipRewardEngine(model=CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE),
                            variables=jax.tree_util.tree_map(np.asarray, jax_engine.variables),
                            tokenizer=Char97Tokenizer(), batch_size=4, device="cpu", **kwargs)


class Running:
    """A server's HTTP front on a free port, in a thread, shut down on exit."""

    def __init__(self, server):
        self.server = server
        self.httpd = server.make_http_server("127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()

    def request(self, path, body=None, headers=None):
        """(status, decoded JSON) of a GET (no body), a JSON POST (dict) or a raw POST (bytes)."""
        if isinstance(body, dict):
            body, headers = json.dumps(body).encode(), {"Content-Type": "application/json"}
        req = urllib.request.Request(self.url + path, data=body, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def _b64(a):
    return base64.b64encode(np.ascontiguousarray(a).tobytes()).decode()


def _shape(a):
    return ",".join(map(str, a.shape))


TEXT = "collect the coin. ¿dónde?"  # non-ASCII: X-Text is percent-encoded UTF-8
# label -> (path, body, headers)
REQUESTS = {
    "text_lists": ("/v1/reward/text", {"frames": FRAMES.tolist(), "text": TEXT}, None),
    "text_list_of_texts": ("/v1/reward/text", {"frames": FRAMES.tolist(), "text": ["reach", "collect"]}, None),
    "text_b64": ("/v1/reward/text", {"frames_b64": _b64(FRAMES), "frames_shape": list(FRAMES.shape),
                                     "text": TEXT}, None),
    "text_raw": ("/v1/reward/text_raw", FRAMES.tobytes(),
                 {"X-Frames-Shape": _shape(FRAMES), "X-Text": urllib.parse.quote(TEXT)}),
    "goal_last_frame_lists": ("/v1/reward/goal", {"frames": FRAMES.tolist()}, None),
    "goal_lists": ("/v1/reward/goal", {"frames": FRAMES.tolist(), "goal": GOAL.tolist()}, None),
    "goal_b64": ("/v1/reward/goal", {"frames_b64": _b64(FRAMES), "frames_shape": list(FRAMES.shape),
                                     "goal_b64": _b64(GOAL), "goal_shape": list(GOAL.shape)}, None),
    "goal_raw": ("/v1/reward/goal_raw", FRAMES.tobytes() + GOAL.tobytes(),
                 {"X-Frames-Shape": _shape(FRAMES), "X-Goal-Shape": _shape(GOAL)}),
    "goal_raw_last_frame": ("/v1/reward/goal_raw", FRAMES.tobytes(), {"X-Frames-Shape": _shape(FRAMES)}),
}
FAULTS = {
    "no_frames": ("/v1/reward/text", {"text": "x"}, None),
    "no_text": ("/v1/reward/text", {"frames": FRAMES.tolist()}, None),
    "bad_b64_shape": ("/v1/reward/goal", {"frames_b64": _b64(FRAMES), "frames_shape": [7, 40, 40, 3]}, None),
    "raw_no_shape": ("/v1/reward/text_raw", FRAMES.tobytes(), {"X-Text": "x"}),
    "raw_no_text": ("/v1/reward/text_raw", FRAMES.tobytes(), {"X-Frames-Shape": _shape(FRAMES)}),
    "raw_negative_dim": ("/v1/reward/goal_raw", FRAMES.tobytes(), {"X-Frames-Shape": "-1,40,40,3"}),
    "raw_byte_count": ("/v1/reward/goal_raw", FRAMES.tobytes()[:-1], {"X-Frames-Shape": _shape(FRAMES)}),
    "raw_goal_byte_count": ("/v1/reward/goal_raw", FRAMES.tobytes() + GOAL.tobytes()[:9],
                            {"X-Frames-Shape": _shape(FRAMES), "X-Goal-Shape": _shape(GOAL)}),
    "unknown_route": ("/v1/reward/nope", {"frames": []}, None),
}


@pytest.fixture(scope="module")
def pair():
    jax_engine = make_tiny_clip_engine(batch_size=4)
    jserver, tserver = JServer(jax_engine), tserve.RewardServer(_port_engine(jax_engine))
    with Running(jserver) as j, Running(tserver) as t:
        yield j, t


@pytest.mark.parametrize("label", list(REQUESTS))
def test_every_route_and_format_answers_as_jax(pair, label):
    j, t = pair
    path, body, headers = REQUESTS[label]
    (j_status, want), (t_status, got) = j.request(path, body, headers), t.request(path, body, headers)
    assert t_status == j_status == 200, (got, want)
    assert len(got["rewards"]) == len(want["rewards"]) == len(FRAMES)
    np.testing.assert_allclose(got["rewards"], want["rewards"], atol=1e-5)


def test_formats_agree_with_each_other_and_the_direct_call(pair):
    _, t = pair
    engine = t.server.engine
    direct = np.asarray(engine.text_rewards(FRAMES, TEXT), np.float32).tolist()
    for label in ("text_lists", "text_b64", "text_raw"):
        assert t.request(*REQUESTS[label])[1]["rewards"] == direct, label
    direct = np.asarray(engine.goal_rewards_vs(FRAMES, GOAL), np.float32).tolist()
    for label in ("goal_lists", "goal_b64", "goal_raw"):
        assert t.request(*REQUESTS[label])[1]["rewards"] == direct, label


@pytest.mark.parametrize("label", list(FAULTS))
def test_faulty_requests_get_jax_s_status_and_error(pair, label):
    j, t = pair
    (j_status, want), (t_status, got) = j.request(*FAULTS[label]), t.request(*FAULTS[label])
    assert t_status == j_status and t_status in (400, 404), (got, want)
    assert got["error"] == want["error"]


def test_text_cache_keys_lru_and_health_match_jax(monkeypatch):
    """Type-prefixed keys ("a" and ["a"] are two entries), least recently used first out, and the health
    fields after the same requests."""
    jax_engine = make_tiny_clip_engine(batch_size=4)
    servers = [JServer(jax_engine), tserve.RewardServer(_port_engine(jax_engine))]
    for server in servers:
        monkeypatch.setattr(server, "MAX_CACHED_TEXTS", 3)
        for text in ("a", ["a"], '["a"]', "b", "a", "c", ["x", "y"]):
            server.text_rewards({"frames": FRAMES[:2].tolist(), "text": text})
        server.goal_rewards({"frames": FRAMES[:3].tolist()})
    (jserver, tserver) = servers
    assert list(tserver._text_feats) == list(jserver._text_feats) == ["str:a", "str:c", 'list:["x", "y"]']
    assert tserve.RewardServer.MAX_CACHED_TEXTS == JServer.MAX_CACHED_TEXTS == 256
    got, want = tserver.health(), jserver.health()
    # the port's own counters besides JAX's fields: 8 requests, every text missed the 3-entry cache and was
    # encoded, and the engine ran seven 2-frame calls and the 3-frame goal call at their own sizes under its
    # batch of 4, nothing padded, one device batch each
    counters = {"requests": 8, "text_cache_hits": 0, "text_cache_misses": 7, "frames_real": 7 * 2 + 3,
                "frames_padded": 0, "batches": 8, "text_encodes": 7}
    assert set(got) == set(want) | set(counters) | {"lock_wait_seconds", "tower_seconds"}
    assert {k: got[k] for k in counters} == counters and got["lock_wait_seconds"] >= 0
    assert 0 < got["tower_seconds"] <= got["busy_seconds"]
    for key in ("status", "batch_size", "cached_texts", "frames_served"):
        assert got[key] == want[key], key
    assert got["engine"] == want["engine"] == "ClipRewardEngine" and got["frames_served"] == 17
    assert got["busy_seconds"] > 0 and got["mean_fps"] > 0


def test_warmup_calibrates_the_int8_scales_as_jax(monkeypatch):
    """Under fast_int8 the warmup frames are the first batch: both servers' static activation scales
    come from them."""
    jax_engine = make_tiny_clip_engine(batch_size=4, fast_int8=True)
    port_engine = _port_engine(make_tiny_clip_engine(batch_size=4), fast_int8=True)
    real = np.random.default_rng(3).integers(0, 256, size=(4, 40, 40, 3), dtype=np.uint8)
    JServer(jax_engine).warmup(real)
    server = tserve.RewardServer(port_engine)
    server.warmup(real)
    got, want = port_engine._fast_q, jax_engine._fast_q
    scales = [k for k in want if k.startswith("a_")]
    layer_scales = [k for k in want["layers"] if k.startswith("a_")]
    assert sorted(scales) == ["a_conv1", "a_final"] and "a_attn_in" in layer_scales
    for key in scales:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=2.0 ** -6, err_msg=key)
    for key in layer_scales:
        np.testing.assert_allclose(got["layers"][key].numpy(), np.asarray(want["layers"][key]), rtol=2.0 ** -6,
                                   err_msg=key)
    before = port_engine._fast_q
    server.text_rewards({"frames": FRAMES.tolist(), "text": "x"})
    assert port_engine._fast_q is before  # calibrated once


def test_cli_flags_reach_the_engine_and_warmup_frames_read_lazily(monkeypatch, tmp_path, capsys):
    jax_engine = make_tiny_clip_engine(batch_size=4)
    variables = jax.tree_util.tree_map(np.asarray, jax_engine.variables)
    built, served = [], []
    monkeypatch.setitem(tengine.MODELS, "vit_b16", lambda: CLIP(**TINY_CLIP_CFG, image_size=TINY_CLIP_IMG_SIZE))
    monkeypatch.setitem(tengine.IMAGE_RESOLUTION, "vit_b16", TINY_CLIP_IMG_SIZE)
    monkeypatch.setattr(tengine, "load_model_vars", lambda name: variables)
    real_init = tengine.ClipRewardEngine.__init__
    monkeypatch.setattr(tengine.ClipRewardEngine, "__init__",
                        lambda self, *a, **k: (built.append(k), real_init(self, *a, **k))[1])
    monkeypatch.setattr(tserve.RewardServer, "warmup", lambda self, frames: served.append(np.asarray(frames)))
    import http.server

    monkeypatch.setattr(http.server.ThreadingHTTPServer, "serve_forever", lambda self: self.server_close())
    path = str(tmp_path / "demo.hdf5")
    windows = np.random.default_rng(4).integers(0, 256, size=(9, 3, 16, 16, 3), dtype=np.uint8)
    with h5py.File(path, "w") as g:
        g.create_dataset("pix", data=windows)
    tserve.main(["--port", "0", "--batch_size", "4", "--resize_mode", "host", "--fast_int8", "--no-fast_int8_attn",
                 "--warmup", "--warmup_frames", f"{path}:pix", "--device", "cpu"])
    assert "serving ClipRewardEngine rewards on http://127.0.0.1:0" in capsys.readouterr().out
    knobs = built[0]
    assert (knobs["resize_mode"], knobs["fast_int8"], knobs["fast_int8_attn"], knobs["batch_size"]) == \
        ("host", True, False, 4)
    np.testing.assert_array_equal(served[0], windows[:2].reshape(-1, 16, 16, 3)[:4])  # two windows cover 4 frames
    np.testing.assert_array_equal(tserve.warmup_frames(path + ":pix", 7), windows[:3].reshape(-1, 16, 16, 3)[:7])
    with pytest.raises(SystemExit):
        tserve.main(["--fast_int8", "--warmup", "--device", "cpu"])  # int8 needs real frames to calibrate on
    with pytest.raises(ValueError, match="requested 100000 devices"):  # --mesh_dp: at most the local devices
        tserve.main(["--mesh_dp", "100000", "--device", "cpu"])
