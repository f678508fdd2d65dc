"""The port's host-side serving modules against the JAX package's copies.

``repro_torch.serve.{scheduler, prefix_cache, metrics, workload}`` and
``repro_torch.obs.trace`` are the port's own copies of the reference's
jax-free modules.  Each test drives both packages through the same trace
and compares the records: the workload (``trace_fingerprint`` byte for
byte), every scheduler decision per tick (admissions with their page rows
and prefix hits, chunk work, demand growth, preemptions, expiries), the
results, cancellations, stats and prefill log, the radix prefix cache and
page-pool refcounts, the metrics summary, and the tracer's event stream.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.obs.trace as j_trace
import repro.serve.metrics as j_metrics
import repro.serve.prefix_cache as j_prefix
import repro.serve.scheduler as j_sched
import repro.serve.workload as j_work
import repro_torch.obs.trace as t_trace
import repro_torch.serve.metrics as t_metrics
import repro_torch.serve.prefix_cache as t_prefix
import repro_torch.serve.scheduler as t_sched
import repro_torch.serve.workload as t_work

torch.set_num_threads(1)

JAX = (j_sched, j_metrics, j_trace, j_work, j_prefix)
PORT = (t_sched, t_metrics, t_trace, t_work, t_prefix)


def _workload(work, seed=0, ticks=14, vocab=64):
    return work.WorkloadConfig(tenants=(
        work.TenantSpec("chat", rate=0.7, prompt_lens=(4, 9),
                        system_prompt_len=8, max_new=6, deadline_slack=14),
        work.TenantSpec("batch", rate=0.35, prompt_lens=(13,), max_new=5,
                        abort_prob=0.4, abort_after=3, timeout=18,
                        burst_every=5, burst_size=1),
    ), ticks=ticks, seed=seed, vocab=vocab)


# (name, scheduler kwargs, speculative k or None, eos id)
CASES = (
    ("fifo", dict(n_slots=3, max_len=32, page_size=4), None, 7),
    ("small pool", dict(n_slots=3, max_len=32, page_size=4, total_pages=12),
     None, -1),
    ("prefix cache", dict(n_slots=3, max_len=32, page_size=4,
                          total_pages=14, prefix_cache=True,
                          prefix_cache_pages=6), None, 11),
    ("chunked", dict(n_slots=2, max_len=32, page_size=4, prefill_chunk=5,
                     prefix_cache=True), None, -1),
    ("speculative", dict(n_slots=3, max_len=40, page_size=4,
                         total_pages=16, prefix_cache=True), 4, 13),
)


def _token(rid, n, tick):
    """A deterministic stand-in for the device's picks."""
    return (rid * 31 + n * 7 + tick) % 53


def _simulate(mods, kwargs, spec_k, eos_id, decode_chunk=3):
    """The continuous engine's host loop without a device: every tick
    expires, admits, issues prefill work, grows pages, then commits
    stand-in tokens.  Returns every record both packages must agree on."""
    sched_mod, metrics_mod, trace_mod, work_mod, _ = mods
    events = work_mod.generate_workload(_workload(work_mod))
    reqs = work_mod.as_requests(events)
    tracer = trace_mod.Tracer(clock="tick", process="serve")
    sched = sched_mod.Scheduler(tracer=tracer, **kwargs)
    met = metrics_mod.MetricsRecorder(tracer=tracer)
    for r in reqs:
        sched.submit(r)
        met.submitted(r.rid, r.arrival, deadline=r.deadline)
    chunked = kwargs.get("prefill_chunk") is not None
    sched.resume_pad = None if chunked else 16
    log, pending, tick = [], set(), 0
    while sched.has_work():
        assert tick < 400, "trace does not drain"
        tracer.set_time(tick)
        tracer.begin("engine", "tick")
        for slot, rid, stage, reason in sched.expire(tick):
            met.cancelled(rid, tick, stage, reason)
            pending.discard(slot)
            log.append(("expire", slot, rid, stage, reason))
        for slot, req, row, pfx in sched.admit(tick):
            met.admitted(req.rid, tick)
            log.append(("admit", slot, req.rid, row.tolist(), pfx,
                        np.asarray(req.prompt).tolist()))
            if not chunked:
                pending.add(slot)
        for slot, req, start, clen, last in sched.prefill_work(tick):
            log.append(("chunk", slot, req.rid, start, clen, last))
            if last:
                pending.add(slot)
        active = sched.decoding_slots()
        if spec_k:
            T = 1 if active else 0
            growth, pre = sched.ensure_capacity(spec_k if active else 0,
                                                advance=False)
        else:
            T = sched.tick_steps(decode_chunk, {s: 1 for s in pending})
            growth, pre = sched.ensure_capacity(T)
        log.append(("grow", [(s, r.tolist()) for s, r in growth], pre, T))
        pending -= set(pre)
        active = [s for s in active if s not in pre]
        counts = []
        for slot in active:
            st = sched.slots[slot]
            rid, toks = st.rid, []
            if slot in pending:
                met.first_token(rid, tick)
                toks.append(_token(rid, len(st.tokens), tick))
            n = 1 + (rid + tick) % spec_k if spec_k else T
            if spec_k:
                sched.advance_written(slot, n)
                counts.append(n)
            toks += [_token(rid, len(st.tokens) + 1 + i, tick)
                     for i in range(n)]
            sched.commit(slot, toks, eos_id)
            if sched.slots[slot] is None:
                met.finished(rid, tick, len(sched.results[rid]))
        pending.clear()
        if spec_k:
            met.spec_tick(counts, spec_k)
        sched.count_tick(T, n_active=len(active))
        met.tick(queue_depth=len(sched.queue), n_active=len(active))
        tracer.end("engine", "tick")
        tick += 1
    met.set_counters(sched.stats)
    pool = sched.pool
    pc = sched.prefix_cache
    return {
        "log": log,
        "results": {r: v.tolist() for r, v in sched.results.items()},
        "cancelled": {r: {k: (np.asarray(v).tolist() if k == "tokens"
                              else v) for k, v in c.items()}
                      for r, c in sched.cancelled.items()},
        "stats": dict(sched.stats),
        "prefill_log": list(sched.prefill_log),
        "utilization": sched.slot_utilization,
        "hit_rate": sched.prefix_hit_rate,
        "refs": {p: pool.refcount(p) for p in range(1, pool.total_pages)},
        "free": pool.free_pages,
        "cached_pages": None if pc is None else pc.cached_pages,
        "summary": json.dumps(met.summary(), sort_keys=True),
        "events": json.dumps(tracer.trace_events(), sort_keys=True),
        "counters": tracer.counters.snapshot(),
        "open": tracer.open_spans(),
    }


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_scheduler_trace_records_match(case):
    _, kwargs, spec_k, eos_id = case
    want = _simulate(JAX, kwargs, spec_k, eos_id)
    got = _simulate(PORT, kwargs, spec_k, eos_id)
    assert want["log"], "the trace admitted nothing"
    for key in want:
        assert got[key] == want[key], key


def test_the_cases_reach_every_path():
    """The traces above preempt, hit the prefix cache, chunk, cancel and
    finish on EOS, so the record comparison covers each path."""
    recs = {c[0]: _simulate(PORT, c[1], c[2], c[3]) for c in CASES}
    assert recs["small pool"]["stats"]["preemptions"] > 0
    assert recs["prefix cache"]["stats"]["preemptions"] > 0
    assert recs["prefix cache"]["stats"]["prefix_tokens_skipped"] > 0
    assert recs["chunked"]["prefill_log"]
    assert recs["small pool"]["cancelled"] and recs["chunked"]["cancelled"]
    assert any(len(v) < 5 for v in recs["fifo"]["results"].values())


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_workload_fingerprint_byte_for_byte(seed):
    want = j_work.generate_workload(_workload(j_work, seed, ticks=40))
    got = t_work.generate_workload(_workload(t_work, seed, ticks=40))
    assert t_work.trace_fingerprint(got) == j_work.trace_fingerprint(want)
    assert [dataclasses.asdict(r) for r in t_work.as_requests(got)].__repr__() \
        == [dataclasses.asdict(r) for r in j_work.as_requests(want)].__repr__()


def test_prefix_cache_match_insert_evict_match():
    def drive(mods):
        sched_mod, _, trace_mod, _, prefix_mod = mods
        tracer = trace_mod.Tracer(clock="tick")
        pool = sched_mod.PagePool(12)
        pc = prefix_mod.PrefixCache(pool, 4, max_pages=5, tracer=tracer)
        rng = np.random.default_rng(5)
        base = rng.integers(0, 9, 12)
        out = []
        for i in range(6):
            toks = np.concatenate([base[:4 * (1 + i % 3)],
                                   rng.integers(0, 9, 4)])
            tracer.set_time(i)
            hit = pc.match(toks)
            pc.count(len(hit))
            pages = pool.alloc(len(toks) // 4 - len(hit)) or []
            out.append(("insert", hit, pc.insert(toks, hit + pages),
                        pc.cached_pages, pool.free_pages))
            pool.free(pages)
            out.append(("evict", pc.evict(1), pc.cached_pages))
        out.append(json.dumps(tracer.trace_events(), sort_keys=True))
        return out

    assert drive(PORT) == drive(JAX)


def test_metrics_percentiles_and_counters_match():
    vals = [3, 1, 4, 1, 5, 9, 2, 6]
    for p in (1, 50, 95, 99, 100):
        assert t_metrics.percentile(vals, p) == j_metrics.percentile(vals, p)
    assert json.dumps(t_metrics.percentile_summary(vals)) == \
        json.dumps(j_metrics.percentile_summary(vals))
    for mod in (t_trace, j_trace):
        c = mod.Counters({"a": 1})
        c.inc("a", 2)
        c.set("b", 5)
    assert t_trace.Counters({"x": 3}).snapshot() == \
        j_trace.Counters({"x": 3}).snapshot()
    assert t_trace.NULL_TRACER.enabled is False
    assert t_trace.REQUIRED_EVENT_KEYS == j_trace.REQUIRED_EVENT_KEYS


def test_tracer_export_matches(tmp_path):
    def drive(mod, path):
        tr = mod.Tracer(clock="tick", process="serve")
        for t in range(3):
            tr.set_time(t)
            tr.begin("engine", "tick")
            tr.instant("req:1", "admit", slot=t)
            tr.counter("pages", t + 1)
            tr.gauge("queue", 0.5 * t)
            with tr.span("engine", "decode", steps=t):
                pass
            tr.end("engine", "tick")
        tr.export(str(path))
        return path.read_bytes(), mod.validate_events(
            mod.load_trace(str(path)))

    got = drive(t_trace, tmp_path / "port.json")
    want = drive(j_trace, tmp_path / "jax.json")
    assert got == want
