"""The rollout's window cache of frozen-tower outputs (arp_tpu_torch/envs/rollout.py::TowerRing, read by
models/policy/models.py::BasePolicy._frozen_frames): each frame goes through the frozen tower once, not once
for every window it sits in.

Tiny policies over seeded torch towers (M3AE, MAE and CLIP) run the same rollout twice, once as it is and once
with the cache withheld from the policy: every call's logits within float32 rounding (the tower sees batches of
another size) and the same actions.  Where the tower trains, where the GCBC joint encode pairs each frame with
its goal, where the instruction differs between rows, and on calls without windows, nothing is reused and the
output is the uncached one bit for bit.  The counters and the ``policy.tower`` span give (3T - 6) / (4T - 6) of
the frames reused over T lockstep steps at window 4, which ``rollout.tower_reuse_pct`` reads."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import arp_tpu_torch.profiling as profiling
from arp_tpu_torch.envs import rollout as troll
from arp_tpu_torch.envs.fake import FakeProcgen
from arp_tpu_torch.models import m3ae as tm3ae
from arp_tpu_torch.models.clip import CLIP
from arp_tpu_torch.models.clip import model as tclip_mod
from arp_tpu_torch.models.policy import models as tpol
from arp_tpu_torch.ops.augment import make_eval_transform
from portbench import run

IMG, PATCH, WINDOW, VOCAB = 32, 16, 4, 211
TOWER = dict(model_type=None, emb_dim=32, dec_emb_dim=16, depth=2, dec_depth=1, num_heads=4, dec_num_heads=4,
             mlp_ratio=2)
TINY_CLIP = dict(embed_dim=16, vocab_size=97, vision_num_layers=1, vision_features=64, vision_patch_size=16,
                 text_features=16, text_num_heads=4, text_num_layers=1)
FAKE = {"episode_length": 8, "image_size": IMG, "grid": 4, "record_video": False}
LOGIT_TOL = 1e-5  # float32 rounding of the tower's GEMMs at another batch size


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tiny_tables(monkeypatch):
    monkeypatch.setattr(tpol, "BERT_VOCAB_SIZE", VOCAB)
    monkeypatch.setitem(tclip_mod.MODELS, "tiny_cache", lambda **kw: CLIP(**TINY_CLIP, image_size=IMG, **kw))


class TwoViews(FakeProcgen):
    """FakeProcgen with a second view, ``side``: the frame upside down."""

    def get_image_state(self, obs):
        return {"image": {"ob": obs, "side": np.ascontiguousarray(obs[::-1])}}


def make_policy(kind="m3ae", cls=tpol.ARPDT, seed=0, views=("ob",), **over):
    """A tiny policy over a seeded frozen (or, with ``use_from_scratch``, trained) tower of ``kind``, its lazy
    layers shaped for ``views``."""
    cfg = dict(dict(model_type="vit_debug", transfer_type="clip_tiny_cache" if kind == "clip" else f"{kind}_vit_b16",
                    emb_dim=32, depth=2, num_heads=4, mlp_ratio=2, use_discrete_action=True, num_ensembles=2,
                    use_adapter=True), **over)
    if kind != "clip":
        cfg[kind] = dict(TOWER, use_type_embedding=False) if kind == "mae" else dict(TOWER)
    torch.manual_seed(seed)
    sub = tpol.get_policy_default_config(cfg)
    if kind == "m3ae":
        pt = tm3ae.MaskedMultimodalAutoencoder(sub.m3ae, text_vocab_size=VOCAB, image_output_dim=PATCH * PATCH * 3)
    elif kind == "mae":
        pt = tm3ae.MaskedAutoencoder(sub.mae, image_output_dim=PATCH * PATCH * 3)
    else:
        pt = CLIP(**TINY_CLIP, image_size=IMG)
    qpack = None
    if sub.frozen_int8:
        frames = np.random.default_rng(seed).integers(0, 255, size=(2, WINDOW, IMG, IMG, 3), dtype=np.uint8)
        qpack = tpol.build_frozen_qpack(cfg, {"image": {"ob": frames}}, PATCH, image_size=IMG,
                                        m3ae_loader=lambda name: pt.state_dict(), device="cpu")
    model = cls(cfg, num_actions=15, patch_dim=PATCH, pt_variables=None if sub.use_from_scratch else pt.state_dict(),
                frozen_qpack=qpack).eval()
    with torch.no_grad():
        model(plain_batch(2, 2, views, text=sub.use_text or cls is not tpol.ARPDT, goal=cls is tpol.GCBC),
              deterministic=True)  # the lazy layers take their shapes
    return model


def plain_batch(b, t, views=("ob",), text=False, goal=False, seed=1):
    """A batch with no windows (a train step's, or a caller's own)."""
    rng = np.random.default_rng(seed)
    batch = {"image": {v: torch.from_numpy(rng.normal(size=(b, t, IMG, IMG, 3)).astype(np.float32)) for v in views},
             "rtg": {v: torch.ones(b, t, 1) for v in views},
             "action": torch.from_numpy(rng.integers(0, 15, size=(b, t))), "instruct": None, "text_padding_mask": None}
    if text:
        batch["instruct"], batch["text_padding_mask"] = instruction(b)
    if goal:
        batch["goal"] = {v: batch["image"][v][:, -1:].expand(-1, t, -1, -1, -1) for v in views}
    return batch


def instruction(b, differ=False):
    ids = torch.arange(1, 17).repeat(b, 1)
    if differ:  # each env its own instruction
        ids = ids + torch.arange(b)[:, None]
    pad = torch.zeros(b, 16)
    pad[:, 11:] = 1.0
    return ids, pad


class Calls:
    """A policy_fn noting each call's last-slot logits; ``withhold`` takes the window cache out of the inputs;
    ``text`` fills the instruction in as build_test_step's policy_fn does (``"differ"``: one per env)."""

    def __init__(self, model, withhold=False, text=None):
        self.model, self.withhold, self.text, self.logits, self.windows = model, withhold, text, [], []

    def __call__(self, inputs, rngs):
        merged = dict(inputs)
        if self.withhold:
            del merged["tower_cache"]
        if self.text is not None:
            merged["instruct"], merged["text_padding_mask"] = instruction(merged["action"].shape[0],
                                                                          differ=self.text == "differ")
        with torch.no_grad():
            logits = self.model(merged, deterministic=True)["action_pred"][:, -1]
        self.logits.append(logits.clone())
        self.windows.append(merged["action"].shape[1])
        return logits.argmax(-1)


def run_rollout(policy_fn, kind="parallel", envs=3, lengths=None, views=1, goal=False):
    """One rollout of ``kind`` on FakeProcgen (``lengths``: each env's episode length; ``views`` 2 adds ``side``)."""
    env_cls, conf = (TwoViews, dict(FAKE, image_key="ob, side")) if views == 2 else (FakeProcgen, dict(FAKE))
    common = dict(transform_obs_fn=make_eval_transform(IMG, device="cpu"), window_size=WINDOW, return_to_go=30.0,
                  scale=10.0, device="cpu")
    if kind == "batch":
        return troll.batch_rollout(rng=0, data_aug_rng=None, env=env_cls("coinrun", conf), policy_fn=policy_fn,
                                   episode_length=conf["episode_length"], num_episodes=2, **common)
    lengths = lengths or [conf["episode_length"]] * envs
    goals = np.stack([FakeProcgen("coinrun", dict(FAKE)).reset(7 + i)["image"]["ob"] for i in range(envs)])
    return troll.parallel_rollout(rng=0, envs=[env_cls("coinrun", dict(conf, episode_length=n)) for n in lengths],
                                  policy_fn=policy_fn, episode_length=max(lengths), goal_images=goals if goal else None,
                                  feed_goal_to_policy=goal, **common)


def counts(model):
    return model.tower_frames_encoded, model.tower_frames_reused


CASES = {
    "m3ae_adapter": (dict(kind="m3ae"), {}),
    "m3ae_fixed_instruction": (dict(kind="m3ae", use_text=True), dict(text="fixed")),
    "m3ae_intermediate": (dict(kind="m3ae", use_intermediate=True), {}),
    "m3ae_frozen_int8": (dict(kind="m3ae", frozen_int8=True), {}),
    "m3ae_two_views": (dict(kind="m3ae", views=("ob", "side")), dict(views=2)),
    "m3ae_envs_finishing_early": (dict(kind="m3ae"), dict(lengths=[2, 5, 8])),
    "m3ae_batch_rollout": (dict(kind="m3ae"), dict(kind="batch")),
    "mae_adapter": (dict(kind="mae"), {}),
    "clip_adapter": (dict(kind="clip"), {}),
    "clip_two_views": (dict(kind="clip", use_adapter=False, views=("ob", "side")), dict(views=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cached_rollout_matches_the_uncached_one(case):
    over, rollout_kw = CASES[case]
    rollout_kw = dict(rollout_kw)
    text = rollout_kw.pop("text", None)
    model = make_policy(**over)
    cached, withheld = Calls(model, text=text), Calls(model, withhold=True, text=text)
    before = counts(model)
    metric = run_rollout(cached, **rollout_kw)
    encoded, reused = (a - b for a, b in zip(counts(model), before))
    assert run_rollout(withheld, **rollout_kw) == metric
    assert len(cached.logits) == len(withheld.logits) > WINDOW
    for t, (got, want) in enumerate(zip(cached.logits, withheld.logits)):
        torch.testing.assert_close(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL, msg=f"call {t}")
        assert torch.equal(got.argmax(-1), want.argmax(-1)), f"call {t}: actions"
    # one new slot of each window a call (each episode of batch_rollout starts its own windows), the rest read back
    frames = (1 if rollout_kw.get("kind") == "batch" else 3) * rollout_kw.get("views", 1)
    assert cached.windows == withheld.windows and cached.windows[0] == 1 and max(cached.windows) == WINDOW
    assert (encoded, reused) == (frames * len(cached.windows), frames * sum(w - 1 for w in cached.windows))


BYPASS = {
    "m3ae_from_scratch": (dict(kind="m3ae", use_from_scratch=True), {}, {}),
    "mae_from_scratch": (dict(kind="mae", use_from_scratch=True), {}, {}),
    "clip_from_scratch": (dict(kind="clip", use_from_scratch=True), {}, {}),
    "gcbc_joint_goal_encode": (dict(kind="m3ae", cls=tpol.GCBC), {}, dict(goal=True)),
    "an_instruction_per_env": (dict(kind="m3ae", use_text=True), dict(text="differ"), {}),
}


@pytest.mark.parametrize("case", list(BYPASS))
def test_the_cache_is_bypassed_where_a_frame_s_output_is_not_its_own(case):
    """A tower that trains, the joint (obs, goal) encode and instructions that differ between rows: every frame
    through the tower, as without windows, bit for bit."""
    over, calls_kw, rollout_kw = BYPASS[case]
    model = make_policy(**over)
    cached, withheld = Calls(model, **calls_kw), Calls(model, withhold=True, **calls_kw)
    encoded0, _ = counts(model)
    run_rollout(cached, **rollout_kw)
    encoded1, reused = counts(model)
    run_rollout(withheld, **rollout_kw)
    assert reused == 0
    frozen = not over.get("use_from_scratch")
    assert encoded1 - encoded0 == (3 * sum(cached.windows) if frozen else 0)
    assert len(cached.logits) == len(withheld.logits)
    for got, want in zip(cached.logits, withheld.logits):
        assert torch.equal(got, want)


class TwoPolicies(Calls):
    """A policy_fn that sums two policies' logits on the same inputs."""

    def __init__(self, first, second, withhold=False):
        super().__init__(first, withhold)
        self.second = Calls(second, withhold)

    def __call__(self, inputs, rngs):
        super().__call__(inputs, rngs)
        self.second(inputs, rngs)
        self.logits[-1] = self.logits[-1] + self.second.logits[-1]
        return self.logits[-1].argmax(-1)


def test_two_policies_on_one_rollout_s_windows_each_encode_the_whole_window():
    """A ring the other policy filled is never read: every frame through each tower, bit for bit."""
    first, second = make_policy("m3ae", seed=0), make_policy("m3ae", seed=1)
    cached, withheld = TwoPolicies(first, second), TwoPolicies(first, second, withhold=True)
    run_rollout(cached)
    run_rollout(withheld)
    assert counts(first)[1] == counts(second)[1] == 0
    assert len(cached.logits) == len(withheld.logits) > WINDOW
    for got, want in zip(cached.logits, withheld.logits):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["m3ae", "mae", "clip"])
def test_calls_without_windows_encode_every_frame(kind):
    """A caller's own batch and a train step's forward with gradients: nothing reused, every frame counted."""
    model = make_policy(kind, views=("ob", "side"))
    batch = plain_batch(3, WINDOW, views=("ob", "side"))
    before = counts(model)
    with torch.no_grad():
        first = model.greedy_action(batch)
    model.train()
    model(batch, deterministic=True)["loss"].backward()
    model.eval()
    with torch.no_grad():
        assert torch.equal(model.greedy_action(batch), first)
    assert counts(model) == (before[0] + 3 * 2 * 3 * WINDOW, 0)


def test_weights_changed_between_evals_are_never_served_from_the_first():
    """Two evals back to back with the frozen tower's weights changed between them: the second's first call
    encodes its whole window, and every call matches an uncached eval on the new weights."""
    model = make_policy("m3ae")
    first = Calls(model)
    run_rollout(first)
    with torch.no_grad():
        for p in model.pt_model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    cached, withheld = Calls(model), Calls(model, withhold=True)
    real, reused_at = model.forward, []

    def forward(batch, *args, **kwargs):
        before = model.tower_frames_reused
        out = real(batch, *args, **kwargs)
        reused_at.append(model.tower_frames_reused - before)
        return out

    model.forward = forward
    run_rollout(cached)
    del model.forward
    run_rollout(withheld)
    assert reused_at[0] == 0 and reused_at[1] > 0
    assert not torch.allclose(first.logits[-1], cached.logits[-1], atol=1e-3)
    for got, want in zip(cached.logits, withheld.logits):
        torch.testing.assert_close(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def _read_reuse_pct():
    return run.load_module(run.HERE / "metrics" / "rollout.tower_reuse_pct.py").read({"window_s": 1.0, "work": {}})


def test_traced_rollout_reads_the_reuse_share():
    """The ``policy.tower`` spans under ``rollout.policy`` carry each call's counts; the metric reads
    (3T - 6) / (4T - 6) over T lockstep steps at window 4, as the counters do."""
    model = make_policy("m3ae")
    calls = Calls(model)
    before = counts(model)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.clear_spans()
        run_rollout(calls)
    encoded, reused = (a - b for a, b in zip(counts(model), before))
    steps = len(calls.logits)
    assert steps > WINDOW
    want = 100.0 * (3 * steps - 6) / (4 * steps - 6)
    assert 100.0 * reused / (encoded + reused) == pytest.approx(want)
    spans = profiling.spans()
    policy = {s.span_id for s in spans if s.name == "rollout.policy"}
    towers = [s for s in spans if s.name == "policy.tower"]
    assert len(towers) == steps and all(s.parent_id in policy for s in towers)
    assert [s.attrs["encoded"] for s in towers] == [3] * steps
    assert _read_reuse_pct() == pytest.approx(want)
    profiling.clear_spans()


def test_tower_ring_holds_the_slots_pushed_since_its_last_fill():
    """A ring of frame numbers against the windows it mirrors: fills after one push, after none, after several,
    and after the fixed inputs changed, always give the ``w`` newest frames, and ask for only what is new."""
    ring, frames, asked = troll.TowerRing(WINDOW), [0], []

    def call(fixed=None):
        w = min(len(frames), WINDOW)
        ring.keep_if(None, fixed)
        k = ring.missing(w)
        asked.append(k)
        new = torch.tensor(frames[len(frames) - k:], dtype=torch.float32).reshape(1, k, 1) if k else None
        got = ring.fill(new, w).reshape(-1).tolist()
        assert got == frames[-w:], (frames, got)

    def push(n=1):
        for _ in range(n):
            frames.append(frames[-1] + 1)
            ring.push()

    call()
    for _ in range(5):
        push()
        call()
    call()  # no push since the last fill
    push(2)  # two steps between calls
    call()
    push(6)  # more steps than the window holds
    call()
    fixed = (torch.ones(1, 3, dtype=torch.long), torch.zeros(1, 3))
    push()
    call(fixed)  # another instruction: the whole window again
    push()
    call(tuple(t.clone() for t in fixed))  # the same values: only the new slot
    assert asked == [1, 1, 1, 1, 1, 1, 0, 2, 4, 4, 1]
