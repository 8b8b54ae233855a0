"""PyTorch port (``repro_torch``) serving runtime, on the CPU.

Mirrors tests/test_tm_serving.py: deterministic units (``Backlog``
admission, typed ``Overloaded`` rejection, weighted round-robin, padding to
buckets) against a stub bucket cache and a fake clock; the bucket cache's
fixed entry set and ``AOTCacheMiss``; and both server modes returning
exactly ``session.scores`` through their threads, which the JAX reference's
scores equal too. Also the port's ground rules: the device rule
(``TMSession(cfg)`` needs CUDA unless ``device="cpu"``), and import hygiene
(no ``jax``, no ``repro`` module reachable from the port,
``chip_smoke.py`` or ``examples/torch_*.py``).
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.session import TMSession, Topology, TsetlinMachine
from repro_torch.core.types import TMConfig, TMState
from repro_torch.serving import (
    AOTBucketCache, AOTCacheMiss, AsyncTMServer, Backlog, Overloaded,
    ScoreResult, SyncTMServer, TenantQueues, buckets)

ROOT = Path(__file__).resolve().parents[1]


# -- deterministic test doubles ---------------------------------------------


class FakeClock:
    """Injectable monotonic clock: time moves only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class StubAOT:
    """Duck-typed AOTBucketCache: records calls, computes nothing."""

    def __init__(self, sizes=(1, 2, 4, 8), n_features=6, n_classes=3):
        self.bucket_sizes = list(sizes)
        self.n_features = n_features
        self.n_classes = n_classes
        self.calls = []
        self.rows = []

    def __call__(self, x, *, engine, bucket):
        assert tuple(x.shape) == (bucket, self.n_features)
        self.calls.append((engine, bucket))
        self.rows.append(x.clone())
        return torch.zeros((bucket, self.n_classes), dtype=torch.int32)

    def counters(self):
        return {"misses": 0}


def make_server(**kw):
    stub = kw.pop("aot", None) or StubAOT()
    clock = kw.pop("clock", None) or FakeClock()
    server = AsyncTMServer(None, None, engine="stub", aot=stub,
                           clock=clock, **kw)
    return server, stub, clock


# -- backlog + admission ----------------------------------------------------


def test_backlog_bounds_rows_and_bytes():
    b = Backlog(max_rows=3, max_bytes=20)
    assert b.try_admit(1, 6) and b.try_admit(1, 6) and b.try_admit(1, 6)
    assert not b.try_admit(1, 1)          # row budget exhausted
    b.release(1, 6)
    assert b.try_admit(1, 2)              # freed row readmits
    assert not b.try_admit(1, 7)          # 14 + 7 > 20: byte budget
    assert (b.rows, b.bytes) == (3, 14)
    with pytest.raises(ValueError):
        Backlog(max_rows=0, max_bytes=1)
    with pytest.raises(ValueError):
        Backlog(max_rows=1, max_bytes=0)


def test_overloaded_typed_rejection_and_release():
    server, stub, clock = make_server(backlog_rows=4)
    clock.advance(1.0)
    admitted = [server.submit(np.zeros(6, np.uint8), tenant="acme")
                for _ in range(4)]
    assert not any(p.done for p in admitted)

    rej = server.submit(np.zeros(6, np.uint8), tenant="acme")
    assert rej.done                        # resolved inside submit
    over = rej.wait(0)
    assert isinstance(over, Overloaded)
    assert over.tenant == "acme" and over.arrival_s == 1.0
    assert over.backlog_rows == 4 and over.max_rows == 4

    clock.advance(2.5)
    assert server.step() == 4              # one synchronous round
    results = [p.wait(0) for p in admitted]
    assert all(isinstance(r, ScoreResult) for r in results)
    assert all(r.latency_s == 2.5 for r in results)
    assert server.backlog.rows == 0        # budget released on completion
    assert not server.submit(np.zeros(6, np.uint8)).done  # admits again

    stats = server.stats()
    assert stats["tenants"]["acme"]["admitted"] == 4
    assert stats["tenants"]["acme"]["rejected"] == 1
    assert stats["tenants"]["acme"]["latency_ms"]["p50"] == 2500.0


def test_byte_budget_rejects_before_row_budget():
    server, _, _ = make_server(backlog_rows=100, backlog_bytes=20)
    assert not server.submit(np.zeros(6, np.uint8)).done  # 6 bytes
    assert not server.submit(np.zeros(6, np.uint8)).done  # 12
    assert not server.submit(np.zeros(6, np.uint8)).done  # 18
    assert server.submit(np.zeros(6, np.uint8)).done      # 24 > 20: rejected


def test_dispatch_pads_to_bucket_from_a_zeroed_staging_buffer():
    server, stub, _ = make_server()
    for _ in range(5):
        server.submit(np.ones(6, np.uint8))
    assert server.step() == 5
    for _ in range(3):
        server.submit(np.full(6, 1, np.uint8))
    assert server.step() == 3
    assert stub.calls == [("stub", 8), ("stub", 4)]
    # the reused buffer's stale rows never leak into the padding
    assert stub.rows[1][:3].eq(1).all() and stub.rows[1][3:].eq(0).all()


def test_staging_buffers_bound_the_batches_in_flight():
    server, _, _ = make_server(inflight=2)
    for _ in range(3):
        server.submit(np.ones(6, np.uint8))
    a = server.dispatch(server.form_batch()[:1])
    server.dispatch([])                    # second slot
    with pytest.raises(RuntimeError, match="in-flight slots"):
        server.dispatch([])
    server.complete(a)                     # frees a buffer
    server.dispatch([])


def test_a_failed_dispatch_resolves_its_promises_with_the_error():
    class Broken(StubAOT):
        def __call__(self, x, *, engine, bucket):
            raise RuntimeError("kernel launch refused")

    server, _, _ = make_server(aot=Broken())
    server.start()
    try:
        p = server.submit(np.ones(6, np.uint8))
        with pytest.raises(RuntimeError, match="launch refused"):
            p.wait(10)
        server.drain(timeout=10)           # the budget came back
    finally:
        server.stop()


# -- tenant fairness --------------------------------------------------------


def test_wrr_hot_tenant_cannot_starve_cold_ones():
    q = TenantQueues()
    for i in range(100):
        q.push("hot", ("hot", i))
    for t in ("a", "b"):
        for i in range(3):
            q.push(t, (t, i))
    batch = q.take(9)
    assert sum(1 for t, _ in batch if t == "hot") == 3
    assert sum(1 for t, _ in batch if t == "a") == 3
    assert sum(1 for t, _ in batch if t == "b") == 3
    assert [i for t, i in batch if t == "hot"] == [0, 1, 2]
    assert len(q) == 97


def test_wrr_weights_shape_the_batch():
    q = TenantQueues(weights={"big": 3})
    for i in range(10):
        q.push("big", ("big", i))
        q.push("small", ("small", i))
    batch = q.take(8)
    assert sum(1 for t, _ in batch if t == "big") == 6
    assert sum(1 for t, _ in batch if t == "small") == 2
    with pytest.raises(ValueError):
        TenantQueues(weights={"x": 0})


def test_buckets_are_powers_of_two_up_to_max_batch():
    assert buckets(32) == [1, 2, 4, 8, 16, 32]
    assert buckets(6) == [1, 2, 4, 6]
    with pytest.raises(ValueError):
        buckets(2, min_batch=4)


# -- real-session integration (CPU: the plain kernel versions) ---------------


def _tiny(engines=("indexed",), seed=0):
    cfg = TMConfig(n_classes=3, n_clauses=16, n_features=12)
    rng = np.random.default_rng(seed)
    inc = rng.uniform(size=(3, 16, 24)) < 0.25
    ta = np.where(inc, cfg.n_states + 1, cfg.n_states).astype(np.int16)
    session = TMSession(cfg, engines=engines, device="cpu")
    return session, session.prepare(TMState(torch.from_numpy(ta))), rng, ta


def test_bucket_cache_prepares_each_bucket_exactly_once():
    session, bundle, rng, _ = _tiny()
    cache = AOTBucketCache(session, bundle, engines=("indexed",), max_batch=4)
    assert cache.bucket_sizes == [1, 2, 4]
    assert cache.counters()["lowerings"] == 3

    x = rng.integers(0, 2, (4, 12)).astype(np.uint8)
    ref = session.scores(bundle, x, engine="indexed")
    for _ in range(2):
        got = cache(torch.from_numpy(x), engine="indexed", bucket=4)
    assert torch.equal(got, ref)
    c = cache.counters()
    assert c["lowerings"] == 3 and c["hits"] == 2 and c["misses"] == 0

    with pytest.raises(AOTCacheMiss):
        cache(np.zeros((3, 12), np.uint8), engine="indexed", bucket=3)
    with pytest.raises(AOTCacheMiss):
        cache(x, engine="bitpack", bucket=4)
    assert cache.counters()["misses"] == 2
    assert cache.counters()["lowerings"] == 3
    assert set(cache.compile_report()["indexed"]) == {"1", "2", "4"}


@pytest.mark.parametrize("engine", ["indexed", "bitpack", "dense"])
@pytest.mark.parametrize("mode", ["async", "sync"])
def test_server_scores_exact_through_threads(mode, engine):
    session, bundle, rng, ta = _tiny(engines=("indexed", "bitpack"))
    cls = AsyncTMServer if mode == "async" else SyncTMServer
    server = cls(session, bundle, engine=engine, max_batch=4).start()
    xs = rng.integers(0, 2, (30, 12)).astype(np.uint8)
    try:
        promises = [server.submit(x, tenant=f"t{i % 2}")
                    for i, x in enumerate(xs)]
        server.drain(timeout=60)
        results = [p.wait(10) for p in promises]
    finally:
        server.stop()
    assert all(isinstance(r, ScoreResult) for r in results)
    served = np.stack([r.scores for r in results])
    ref = session.scores(bundle, xs, engine=engine).numpy()
    np.testing.assert_array_equal(served, ref)

    stats = server.stats()
    assert stats["completed"] == 30 and stats["backlog_rows"] == 0
    assert stats["rows_real"] == 30
    assert stats["aot"]["misses"] == 0
    assert stats["aot"]["lowerings"] == 3
    assert set(stats["tenants"]) == {"t0", "t1"}


def test_served_scores_equal_the_jax_reference():
    jax = pytest.importorskip("jax")
    from repro.core import TMConfig as JConfig, TMState as JState
    from repro.core.session import TMSession as JSession

    session, bundle, rng, ta = _tiny(engines=("indexed", "bitpack"))
    jsession = JSession(JConfig(n_classes=3, n_clauses=16, n_features=12),
                        engines=("indexed", "bitpack"))
    jbundle = jsession.prepare(JState(ta_state=jax.numpy.asarray(ta)))
    xs = rng.integers(0, 2, (20, 12)).astype(np.uint8)
    server = AsyncTMServer(session, bundle, engine="indexed",
                           max_batch=8).start()
    try:
        out = np.stack([p.wait(30).scores for p in
                        [server.submit(x) for x in xs]])
    finally:
        server.stop()
    for engine in ("indexed", "bitpack"):
        np.testing.assert_array_equal(
            out, np.asarray(jsession.scores(jbundle, xs, engine=engine)))


def test_tm_serve_run_record_on_cpu():
    from repro_torch.launch.tm_serve import ServePolicy, resolve_flags, run

    record = run(TMConfig(n_classes=3, n_clauses=16, n_features=12),
                 engines=("indexed", "bitpack"), n_requests=12, rps=4000.0,
                 policy=ServePolicy(max_batch=4), device="cpu")
    assert record["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    for e in ("indexed", "bitpack"):
        assert record["engines"][e]["requests"] == 12
        assert set(record["engines"][e]["warm_s_per_bucket"]) == {"1", "2", "4"}
    assert resolve_flags(True, requests=32, max_batch=None) == \
        {"requests": 32, "max_batch": 8}


# -- ground rules -----------------------------------------------------------


def test_entry_points_need_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TMConfig(n_classes=2, n_clauses=4, n_features=3)
    for make in (lambda **kw: TMSession(cfg, **kw),
                 lambda **kw: TsetlinMachine(cfg, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        assert make(device="cpu").device == torch.device("cpu")
    from repro_torch.launch.tm_serve import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--smoke"])


def test_cpu_machine_trains_and_a_clause_sharded_one_matches_it():
    """A CPU machine trains (its served caches follow), and a clause-sharded
    one trains as the single-device one does from the same seed."""
    cfg = TMConfig(n_classes=2, n_clauses=4, n_features=3)
    machine = TsetlinMachine(cfg, device="cpu", seed=1).init()
    xs = np.array([[1, 0, 1], [0, 1, 0]] * 4, np.uint8)
    machine.fit(xs, np.array([0, 1] * 4), epochs=3, batch_size=4)
    assert machine.event_overflow == 0
    assert not torch.equal(machine.state.ta_state,
                           torch.full_like(machine.state.ta_state, cfg.n_states))
    assert torch.equal(machine.scores(xs, engine="indexed"),
                       machine.scores(xs, engine="dense"))
    sharded = TsetlinMachine(cfg, topology=Topology(clause_shards=2),
                             device="cpu", seed=1).init()
    sharded.fit(xs, np.array([0, 1] * 4), epochs=3, batch_size=4)
    assert torch.equal(sharded.state.ta_state, machine.state.ta_state)


HYGIENE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_neither_jax_nor_the_reference():
    res = subprocess.run([sys.executable, "-c", HYGIENE],
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules, bad = res.stdout.split(maxsplit=1)
    assert int(n_modules) >= 20
    assert bad.strip() == "[]", bad


def import_roots(path: Path) -> set[str]:
    """Top-level package names a Python file imports, anywhere in it."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    roots = import_roots(ROOT / "chip_smoke.py")
    assert "repro_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_torch_examples_import_neither_jax_nor_the_reference():
    paths = sorted((ROOT / "examples").glob("torch_*.py"))
    assert {"torch_quickstart.py", "torch_tm_mnist.py", "torch_serve_lm.py",
            "torch_train_lm.py"} <= {p.name for p in paths}
    for path in paths:
        roots = import_roots(path)
        assert "repro_torch" in roots, path.name
        assert not roots & {"jax", "jaxlib", "repro"}, (path.name, roots)
