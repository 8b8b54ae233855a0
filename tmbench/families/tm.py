"""The Tsetlin Machine family: a configuration file that states a TM's
sizes and dtypes (``tmbench/configs/tm_*.json``), read as the port's
``TMConfig``. A configuration without a ``family`` key is of this family.

A TM configuration runs at the paper's published widths, nothing cut
(``reduced`` is empty), with int16 TA states and int32 votes.

Its control (``tmbench.control``): the reference put in the program's
place in the precision below the configuration's, TA states held in int8
where they are stated int16 (scoring kinds), uniforms in bfloat16 where
they are stated float32 (training kinds).
"""
from __future__ import annotations

import contextlib

STATE_DTYPES = ("int16",)
SCORING = ("open_loop", "offline_score")     # the family's kinds that score
# the CPU tests' cut: a few classes, clauses and features
TINY = {"n_classes": 3, "n_clauses": 32, "n_features": 16, "threshold": 5,
        "avg_clause_len": 4}


def config(conf: dict):
    """The ``TMConfig`` a configuration file states."""
    import torch

    from repro_torch.core.types import TMConfig

    if conf["state_dtype"] not in STATE_DTYPES:
        raise ValueError(f"state_dtype {conf['state_dtype']!r} is not one "
                         f"of {STATE_DTYPES}")
    return TMConfig(n_classes=conf["n_classes"],
                    n_clauses=conf["n_clauses"],
                    n_features=conf["n_features"],
                    n_states=conf["n_states"], s=float(conf["s"]),
                    threshold=conf["threshold"],
                    boost_true_positive=conf["boost_true_positive"],
                    empty_clause_output=conf["empty_clause_output"],
                    state_dtype=getattr(torch, conf["state_dtype"]))


def check(conf: dict, entry: dict) -> None:
    """A TM configuration's own invariants (``entry``: its entry in
    ``BENCHMARK.json``); raises ValueError."""
    name = conf["name"]
    if conf["reduced"] != [] or entry["reduced"] != []:
        raise ValueError(f"{name}: a TM configuration runs at its published "
                         "widths, so its reduced is []")
    if conf["state_dtype"] != "int16" or conf["vote_dtype"] != "int32":
        raise ValueError(f"{name}: TA states are int16 and votes int32, not "
                         f"{conf['state_dtype']} and {conf['vote_dtype']}")
    config(conf)


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name = value`` for the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def mode(kind: str, which: str):
    """The program's path as ``which`` (one of ``tmbench.control.MODES``)
    says, for the block, in a cell of traffic kind ``kind``."""
    from repro_torch.core import engines, session, tm
    from repro_torch.core.types import TMState

    from tmbench.reference import tm as ref

    if which == "program":
        yield
        return
    if kind in SCORING:
        scores = engines.IndexedEngine.scores
        if which == "control":
            held = {}
            prepare = session.TMSession.prepare

            def keep(self, state):
                held["ta"] = state.ta_state.clone()
                return prepare(self, state)

            def control(self, cfg, cache, x):
                inc = ref.include_of(held["ta"], cfg.n_states, control=True)
                return ref.scores(inc, x)

            with patched(session.TMSession, "prepare", keep), \
                    patched(engines.IndexedEngine, "scores", control):
                yield
            return

        def broken(self, cfg, cache, x):
            out = scores(self, cfg, cache, x).clone()
            if which == "altered":
                out[0, 0] += 1
            else:
                out[out.shape[0] // 2:] = 0
            return out

        with patched(engines.IndexedEngine, "scores", broken):
            yield
        return

    step = session.TMSession.train_step
    if which == "control":
        def control_round(cfg, state, xs, ys, draws, *, mask=None, **kw):
            ta = state.ta_state.clone()
            d = ref.Draws(cfg.n_classes, cfg.n_clauses, cfg.n_literals, 0,
                          ta.device, generator=draws)
            hp = {"n_states": cfg.n_states, "s": cfg.s,
                  "threshold": cfg.threshold,
                  "boost_true_positive": cfg.boost_true_positive}
            ref.learn_step(ta, xs, [int(v) for v in tm._host_list(ys, len(xs))],
                           d, hp, control=True)
            return TMState(ta_state=ta)

        with patched(tm, "update_batch_sequential", control_round):
            yield
        return
    if which == "unchanged":
        def unchanged(self, bundle, xs, ys, draws, mask=None):
            step(self, bundle, xs, ys, draws, mask)     # the step's work...
            return bundle                               # ...and its input back
        new_step = unchanged
    elif which == "half_batch":
        def half(self, bundle, xs, ys, draws, mask=None):
            import numpy as np
            b = len(ys)
            return step(self, bundle, xs, ys, draws,
                        mask=np.arange(b) < b // 2)
        new_step = half
    else:
        def altered(self, bundle, xs, ys, draws, mask=None):
            out = step(self, bundle, xs, ys, draws, mask)
            ta = out.state.ta_state
            n_states = out.cfg.n_states
            ta[0, 0, 0] = n_states + 1 if int(ta[0, 0, 0]) <= n_states else n_states
            return out
        new_step = altered
    with patched(session.TMSession, "train_step", new_step):
        yield
