"""Port parity: VisionServeEngine vs the reference (CPU).

The engines run under ``VirtualClock``s with fixed rates, so every
timestamp and cost EWMA is deterministic; the port is given the reference
engine's own initialised weights.  Both of the port's ingest paths
(``use_kernels`` off and on, the plain versions on the CPU) are held
against both of the reference's (``use_pallas`` off and on, Pallas in
interpret mode): per-stream counters, flag results and every
``SegmentRecord`` field must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import EDAConfig as JEDAConfig
from repro.core.clock import FRAME as JFRAME, TICK as JTICK
from repro.core.clock import VirtualClock as JVirtualClock
from repro.streams import INNER as JINNER, OUTER as JOUTER
from repro.streams import VisionServeEngine as JEngine
from repro.streams.tiers import stream_thresh as j_stream_thresh
from repro_torch import convert
from repro_torch.config import EDAConfig
from repro_torch.core.clock import FRAME, TICK, VirtualClock
from repro_torch.data.synthetic import frame_loop
from repro_torch.streams import INNER, OUTER, MotionGate, VisionServeEngine
from repro_torch.streams.tiers import stream_thresh
from test_torch_gate import _clip

RATES = {"frame": 0.004, "tick": 0.0002}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs test files in parallel workers: one intra-op thread
    keeps torch's CPU ops from contending with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def _flagging(dp):
    """Random weights give near-uniform class scores, so no hazard would
    ever fire and flag parity would hold vacuously.  A person-class head
    bias puts the best score around the 0.5 keep threshold, so hazards
    fire on some frames and not on others."""
    anchor_width = 11 + 4                    # classes + background, box
    b = np.zeros(dp["head"]["b"].shape, np.float32)
    b[1::anchor_width] = 2.3
    return dict(dp, head=dict(dp["head"], b=jnp.asarray(b)))


def _engines(kernels, *, slots, use_gate=True, tier=None, esd=0.0,
             quantum=32, seed=0):
    # model resolution 48: a 3x3 output grid, where distraction flags fire
    common = dict(slots=slots, frame_res=64, input_res=48, fps=10,
                  use_gate=use_gate, quantum=quantum, tier=tier)
    je = JEngine("r0", **common, use_pallas=kernels, pallas_interpret=True,
                 eda=JEDAConfig(esd=esd),
                 clock=JVirtualClock(rates={JFRAME: RATES["frame"],
                                            JTICK: RATES["tick"]}),
                 rng=jax.random.key(seed))
    je.dp = _flagging(je.dp)
    params = (convert.detector_from_jax(jax.tree.map(np.asarray, je.dp),
                                        device="cpu"),
              convert.pose_from_jax(jax.tree.map(np.asarray, je.pp),
                                    device="cpu"))
    te = VisionServeEngine("r0", **common, use_kernels=kernels,
                           eda=EDAConfig(esd=esd),
                           clock=VirtualClock(rates={FRAME: RATES["frame"],
                                                     TICK: RATES["tick"]}),
                           params=params, device="cpu")
    return je, te


def _drive(eng, outer, inner, thresh, streams, frames, close_at=None,
           deadline=0.0):
    """Open ``streams`` (outer/inner alternating), push ``frames`` frames
    each, drain; close every stream.  Returns per-stream outcomes (with
    each stream's gate threshold read by ``thresh``), the ledger records
    and the engine stats."""
    keys = [(f"s{i}", outer if i % 2 == 0 else inner)
            for i in range(streams)]
    for k, kind in keys:
        eng.open_stream(k, kind, deadline_ms=deadline)
    clips = {k: _clip(frames, 64, seed=10 + i)
             for i, (k, _) in enumerate(keys)}
    for t in range(frames):
        for k, _ in keys:
            eng.push(k, clips[k][t])
        if close_at is not None and t == close_at:
            eng.step()
    eng.drain()
    out = {k: (s.processed, s.gated, s.dropped, s.deadline_dropped,
               s.flagged, list(eng.results[k]), thresh(eng, k))
           for k, s in eng.streams.items()}
    for k, _ in keys:
        eng.close_stream(k)
    eng.ledger.check()
    recs = [dataclasses.asdict(r) for r in eng.ledger.records]
    return out, recs, eng.stats()


CASES = [
    # (id, kwargs for _engines, kwargs for _drive, record field that must
    #  be non-zero somewhere, so the case exercises what it names)
    ("gate_2slots", dict(slots=2), dict(streams=2, frames=9),
     "frames_gated"),
    ("oversubscribed_rotation", dict(slots=3, quantum=3),
     dict(streams=5, frames=8, close_at=2), "frames_gated"),
    ("gateless", dict(slots=2, use_gate=False), dict(streams=3, frames=6),
     "frames_processed"),
    ("frugal_bf16_pool", dict(slots=2, tier="frugal"),
     dict(streams=2, frames=6), "frames_gated"),
    ("esd_deadline_trims", dict(slots=2, esd=2.0),
     dict(streams=3, frames=8, deadline=20.0), "frames_deadline_dropped"),
]


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_engine_matches_reference(case, kernels):
    _, ekw, dkw, nonzero = case
    je, te = _engines(kernels, **ekw)
    jout, jrecs, jstats = _drive(je, JOUTER, JINNER, j_stream_thresh, **dkw)
    tout, trecs, tstats = _drive(te, OUTER, INNER, stream_thresh, **dkw)
    assert tout == jout
    assert trecs == jrecs
    assert tstats == jstats
    assert sum(r["frames_processed"] for r in trecs) > 0
    assert sum(r[nonzero] for r in trecs) > 0


def test_engine_kernel_path_counts_no_launches_on_cpu():
    from repro_torch.kernels import vision_ops as tvo
    tvo.reset_launches()
    _, te = _engines(True, slots=2)
    _drive(te, OUTER, INNER, stream_thresh, streams=2, frames=3)
    assert sum(tvo.LAUNCHES.values()) == 0


def test_engine_validates_gate_and_frames():
    with pytest.raises(ValueError, match="gate.slots"):
        VisionServeEngine("e", slots=4, gate=MotionGate(2, device="cpu"),
                          device="cpu")
    with pytest.raises(ValueError, match="use_gate=False"):
        VisionServeEngine("e", slots=2, use_gate=False,
                          gate=MotionGate(2, device="cpu"), device="cpu")
    eng = VisionServeEngine("e", slots=2, frame_res=64, input_res=32,
                            gate=MotionGate(2, init_thresh=0.2, device="cpu"),
                            device="cpu")
    assert eng.gates[INNER].init_thresh == 0.2
    assert eng.gates[INNER] is not eng.gates[OUTER]
    eng.open_stream("a", OUTER)
    with pytest.raises(ValueError, match="frame shape"):
        eng.push("a", np.zeros((32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="kind"):
        eng.open_stream("b", "sideways")


def test_detach_adopt_keeps_counters_and_gate_threshold():
    a = VisionServeEngine("a", slots=1, frame_res=64, input_res=32,
                          use_kernels=True, clock=VirtualClock(RATES),
                          device="cpu")
    b = VisionServeEngine("b", slots=1, frame_res=64, input_res=32,
                          use_kernels=True, clock=VirtualClock(RATES),
                          device="cpu", params=(a.dp, a.pp))
    at = frame_loop(1, res=64, frames=8)
    a.open_stream("v", OUTER)
    for t in range(6):
        a.push("v", at(t))
    a.step()
    a.step()
    a.gates[OUTER].thresh[0] = 0.123
    st = a.detach_stream("v")
    assert st.gate_state["thresh"] == pytest.approx(0.123)
    b.adopt_stream(st)
    assert stream_thresh(b, "v") == pytest.approx(0.123)
    b.drain()
    rec = b.close_stream("v")
    assert rec.frames_processed + rec.frames_gated == 6
