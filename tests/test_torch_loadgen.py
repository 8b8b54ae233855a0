"""PyTorch port (``repro_torch``) open-loop load generator, the schema-2
``tm_serve`` record and the data pipeline's ``Prefetcher``, on the CPU.

``poisson_arrivals`` gives the reference's arrays from the same numpy seed,
``holds`` / ``find_knee`` give the reference's verdicts on the same step
records, ``run_step`` / ``sustained_load`` give records with the
reference's keys (plus the port's ``submitted_rps``) and no bucket
preparation inside the timed loop, and ``tm_serve --device cpu --smoke``
writes schema 2 with both sections. Timing-dependent numbers are checked
for shape and sign only.
"""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import TMConfig as JConfig  # noqa: E402
from repro.core.session import TMSession as JSession  # noqa: E402
from repro.core.types import TMState as JState  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.serving import AsyncTMServer as JServer  # noqa: E402
from repro.serving import loadgen as jloadgen  # noqa: E402
from repro_torch.core.session import TMSession  # noqa: E402
from repro_torch.core.types import TMConfig, TMState  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, TMBatcher  # noqa: E402
from repro_torch.launch import tm_serve  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    AsyncTMServer, find_knee, holds, poisson_arrivals, run_step,
    sustained_load)

CFG = dict(n_classes=3, n_clauses=16, n_features=12)


@pytest.mark.parametrize("rps, duration", [(2000.0, 0.5), (37.5, 1.0),
                                           (0.5, 1.0), (1e5, 0.01)])
def test_poisson_arrivals_match_reference(rps, duration):
    for seed in (0, 7):
        got = poisson_arrivals(rps, duration, np.random.default_rng(seed))
        want = jloadgen.poisson_arrivals(rps, duration,
                                         np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        assert got.size >= 1 and np.all(np.diff(got) >= 0)


def step(offered, achieved, rejection_rate):
    return {"offered_rps": offered, "achieved_rps": achieved,
            "rejection_rate": rejection_rate}


STEP_CURVES = [
    [step(100, 99, 0), step(200, 190, 0), step(400, 250, 0.3)],
    [step(100, 79.9, 0), step(200, 170, 0.011), step(400, 150, 0.5)],
    [step(100, 80, 0.01), step(200, 161, 0.0), step(400, 330, 0.02)],
    [step(500, 100, 0.6)],
]


@pytest.mark.parametrize("steps", STEP_CURVES)
def test_holds_and_find_knee_match_reference(steps):
    assert [holds(s) for s in steps] == [jloadgen.holds(s) for s in steps]
    assert find_knee(steps) == jloadgen.find_knee(steps)


def _random_ta(cfg, seed):
    rng = np.random.default_rng(seed)
    inc = rng.uniform(size=(cfg.n_classes, cfg.n_clauses, 2 * cfg.n_features)) < 0.2
    return np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16)


def test_sustained_load_record_has_the_reference_keys():
    """The same two-step ladder through the reference's server and the
    port's CPU server: same record keys (the port adds ``submitted_rps``
    per step), every request served, nothing prepared in the hot loop."""
    ta = _random_ta(JConfig(**CFG), 1)
    xs = np.random.default_rng(2).integers(0, 2, (32, 12)).astype(np.uint8)
    jsession = JSession(JConfig(**CFG), engines=("indexed",))
    jbundle = jsession.prepare(JState(ta_state=jnp.asarray(ta)))
    jserver = JServer(jsession, jbundle, engine="indexed", max_batch=4)
    try:
        want = jloadgen.sustained_load(jserver, xs, rps_steps=[200, 400],
                                       step_duration_s=0.05, seed=3)
    finally:
        jserver.stop()
    session = TMSession(TMConfig(**CFG), engines=("indexed",), device="cpu")
    server = AsyncTMServer(session, session.prepare(TMState(torch.from_numpy(ta))),
                           engine="indexed", max_batch=4)
    try:
        got = sustained_load(server, xs, rps_steps=[200, 400],
                             step_duration_s=0.05, seed=3)
    finally:
        server.stop()
    assert set(got) == set(want)
    assert set(got["knee"]) == set(want["knee"])
    assert set(got["aot"]) == set(want["aot"])
    for g, w in zip(got["steps"], want["steps"]):
        assert set(g) == set(w) | {"submitted_rps"}
        assert set(g["latency_ms"]) == set(w["latency_ms"])
        # the same seed offers the same arrivals to both servers
        assert (g["requests"], g["offered_rps"]) == \
            (w["requests"], w["offered_rps"])
        assert g["completed"] == g["requests"] and g["rejected"] == 0
        assert g["submitted_rps"] > 0 and g["achieved_rps"] > 0
    assert got["open_loop"] is True and got["engine"] == "indexed"
    assert got["aot"]["hot_loop_compiles"] == 0 and got["aot"]["misses"] == 0


def test_run_step_reports_rejections_past_the_backlog():
    cfg = TMConfig(**CFG)
    session = TMSession(cfg, engines=("indexed",), device="cpu")
    bundle = session.prepare(TMState(torch.from_numpy(_random_ta(cfg, 4))))
    server = AsyncTMServer(session, bundle, engine="indexed", max_batch=2,
                           backlog_rows=1, inflight=1)
    xs = np.zeros((4, 12), np.uint8)
    try:
        server.start()
        rec = run_step(server, xs, rps=50_000.0, duration_s=0.01,
                       rng=np.random.default_rng(0))
    finally:
        server.stop()
    assert rec["requests"] == rec["completed"] + rec["rejected"]
    assert rec["rejected"] > 0 and rec["rejection_rate"] > 0
    assert not holds(rec)


def test_tm_serve_writes_schema_2_with_both_sections(tmp_path):
    out = tmp_path / "serve.json"
    tm_serve.main(["--device", "cpu", "--smoke", "--devices", "cpu,cpu",
                   "--step-duration", "0.05", "--requests", "16",
                   "--out", str(out)])
    record = json.loads(out.read_text())
    assert record["schema"] == 2
    sustained = record["sustained_load"]
    assert set(sustained["engines"]) == {"indexed", "bitpack"}
    assert sustained["ladder"] == list(tm_serve.ASYNC_LADDER)
    assert sustained["device"]["platform"] == "cpu"
    for rec in sustained["engines"].values():
        assert rec["aot"]["hot_loop_compiles"] == 0
        assert len(rec["steps"]) == len(tm_serve.ASYNC_LADDER)
        assert rec["sync_baseline"]["achieved_rps"] > 0
        assert 0 <= rec["knee"]["index"] < len(rec["steps"])
    rows = record["batch_axis_scaling"]
    assert [r["data_shards"] for r in rows] == [1, 2]
    assert [r["devices"] for r in rows] == [1, 1]
    assert rows[1]["mesh"] == ["cpu", "cpu"]
    assert rows[1]["placement"] == "2 shards on one device (cpu)"
    assert all(r["engine"] == "indexed" and r["throughput_rps"] > 0
               for r in rows)


def test_scaling_sweeps_distinct_devices_unless_given_a_list():
    cfg = TMConfig(**CFG)
    policy = tm_serve.ServePolicy(max_batch=4)
    rows = tm_serve.run_batch_axis_scaling(cfg, device="cpu", n_requests=8,
                                           policy=policy)
    assert [(r["data_shards"], r["placement"]) for r in rows] == \
        [(1, "1 shard on cpu")]
    rows = tm_serve.run_batch_axis_scaling(cfg, devices=["cpu"] * 8,
                                           n_requests=8, policy=policy)
    assert [r["data_shards"] for r in rows] == [1, 2, 4]   # ≤ max_batch
    assert tm_serve.placement([torch.device("cuda", 0)] * 4) == \
        "4 shards on one card (cuda:0)"
    assert tm_serve.placement(["cuda:0", "cuda:1"]) == \
        "2 shards on 2 devices (cuda:0, cuda:1)"


def test_tm_serve_refuses_a_device_list_shorter_than_the_topology(tmp_path):
    with pytest.raises(SystemExit, match="need 4"):
        tm_serve.main(["--device", "cpu", "--smoke", "--clause-shards", "2",
                       "--data-shards", "2", "--devices", "cpu,cpu",
                       "--out", str(tmp_path / "x.json")])


def test_prefetcher_orders_steps_like_the_reference():
    batcher = TMBatcher(12, 3, 4, seed=9)
    pf = Prefetcher(batcher, start_step=5, depth=2)
    it = iter(pf)
    got = [next(it) for _ in range(4)]
    pf.close()
    assert not pf._thread.is_alive()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    np.testing.assert_array_equal(got[0][1]["x"], batcher(5)["x"])
    theirs = jpipeline.Prefetcher(jpipeline.TMBatcher(12, 3, 4, seed=9),
                                  start_step=5, depth=2)
    it = iter(theirs)
    want = [next(it) for _ in range(4)]
    theirs.close()
    for (s, a), (t, b) in zip(got, want):
        assert s == t
        np.testing.assert_array_equal(a["x"], b["x"])
        np.testing.assert_array_equal(a["y"], b["y"])
