"""The port's round telemetry against the JAX package's.

(a) The off path is off: an unknown `telemetry` value is refused; with
    telemetry off every round kind's metrics keyset is exactly the
    one it had before telemetry; trajectories (state and metrics) with
    telemetry on and off are bitwise identical; with it off the round
    never reaches `_telemetry_metrics` (or the byte split, or the
    entropy), and the kernel wrappers are called exactly as often on
    and off.
(b) Every ``tel/*`` key against the JAX round on injected inputs, through
    `test_torch_downlink.rounds_against_jax` (the whole state carried
    across before every round): integer, mask and byte fields exactly,
    with the reference's dtypes, `tel/weight_entropy` to 1e-5; the
    parallel round on both engines across uplink x downlink (delta
    included, at partial participation), the buffered tick under a
    fixed arrival schedule, and the sequential round.
(c) The stream (modelled on tests/test_telemetry.py): scanned == stepwise
    event for event; the final partial block gives an exact round count;
    `telemetry_every` subsamples; the eval sentinel is the reference's
    constant and is masked; the buffered stream carries staleness and
    occupancy; CSV gets one row per node; a JSONL stream of the port
    validates under the JAX package's own `validate_events`, gives its
    rounds to target through the reference's `report`, and
    `scripts/flstat.py` reads it (exit 0); the manifest's config hash is
    the reference's.
"""
import csv
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro
import repro_torch
import test_torch_downlink
from repro.telemetry import manifest as jmanifest
from repro.telemetry import report as jreport
from repro.telemetry import schema as jschema
from repro_torch.core import driver, treemath
from repro_torch.core import fl as tfl
from repro_torch.data import synthetic
from repro_torch.telemetry import report, schema, sinks, spans
from test_torch_downlink import rounds_against_jax, toy_problem

FLSTAT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "flstat.py")

OFF_KEYS_SYNC = {"loss", "theta", "theta_smoothed", "weights", "divergence",
                 "lr", "cos", "expected_contribution", "accuracy"}
OFF_KEYS_BUFFERED = OFF_KEYS_SYNC | {"flushed", "buffer_landed",
                                     "staleness"}
TEL_KEYS_SYNC = {"tel/nodes", "tel/cohort", "tel/weight_entropy",
                 "tel/bytes_up", "tel/bytes_down"}
TEL_KEYS_DELTA = {"tel/bytes_down_delta", "tel/bytes_down_full"}
TEL_KEYS_BUFFERED = {"tel/ages", "tel/landed", "tel/occupancy"}
# the tel/* keys held exactly (the entropy is held to 1e-5)
EXACT_TEL_KEYS = (TEL_KEYS_SYNC | TEL_KEYS_DELTA | TEL_KEYS_BUFFERED) - {
    "tel/weight_entropy"}



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small rounds, and when
    several test processes share the CPU torch's default thread pool
    oversubscribes it (a round then slows by an order of magnitude)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.fixture(scope="module")
def task():
    train, test = synthetic.make_image_task(seed=0, num_train=1500,
                                            num_test=200)
    nodes = synthetic.make_federated(
        train, [("iid", None)] * 3 + [("xclass", 1)] * 3,
        samples_per_node=100, seed=1)
    return nodes, test


def _cfg(**kw):
    base = dict(num_clients=6, clients_per_round=6, local_steps=2,
                method="fedadp", base_lr=0.05, telemetry="node")
    base.update(kw)
    return repro_torch.FLConfig(**base)


def _server(task, cfg, arrival_fn=None):
    nodes, test = task
    return repro_torch.FedServer("mlr", cfg, nodes[:cfg.num_clients], test,
                                 batch_size=50, seed=0, device="cpu",
                                 arrival_fn=arrival_fn)


# a straggler in tick 0 and a drop in tick 1 (6 candidates a tick)
DELAYS = np.zeros((4, 6), np.int32)
DELAYS[0, 0] = 2
DROPS = np.zeros((4, 6), bool)
DROPS[1, 4] = True

# (id, config, off keys, tel keys) over every kind of round
ROUND_KINDS = [
    ("flat-int8ef-delta-partial",
     dict(engine="flat", clients_per_round=4, transport="int8",
          error_feedback=True, downlink="int8", downlink_delta=True,
          downlink_ring=2), OFF_KEYS_SYNC, TEL_KEYS_SYNC | TEL_KEYS_DELTA),
    ("tree-bf16-dlef", dict(engine="tree", transport="bf16",
                            downlink="bf16", downlink_error_feedback=True),
     OFF_KEYS_SYNC, TEL_KEYS_SYNC),
    ("buffered-int4-delta",
     dict(engine="flat", aggregation="buffered", buffer_m=4,
          transport="int4", group_size=8, downlink="int8",
          downlink_delta=True),
     OFF_KEYS_BUFFERED,
     TEL_KEYS_SYNC | TEL_KEYS_DELTA | TEL_KEYS_BUFFERED),
    ("sequential", dict(mode="sequential"), OFF_KEYS_SYNC, TEL_KEYS_SYNC),
]


def _kind_server(task, kw, telemetry):
    arrival = (repro_torch.fixed_arrival_schedule(DELAYS, DROPS)
               if kw.get("aggregation") == "buffered" else None)
    return _server(task, _cfg(telemetry=telemetry, **kw), arrival)


# ------------------------------------------------- (a) the off path is off


def test_validate_rejects_unknown_telemetry():
    with pytest.raises(ValueError, match="unknown telemetry"):
        _cfg(telemetry="verbose").validate()


@pytest.mark.parametrize("name,kw,off,tel", ROUND_KINDS,
                         ids=[b[0] for b in ROUND_KINDS])
def test_off_keyset_is_exactly_the_pre_telemetry_set(task, name, kw, off,
                                                     tel):
    assert set(_kind_server(task, kw, None).step(eval_every=1)) == off
    m = _kind_server(task, kw, "node").step(eval_every=1)
    assert set(m) == off | tel


def _state_bytes(state):
    tree = tfl.state_to_tree(state)
    return [(p, bytes(leaf.numpy().tobytes()) if isinstance(
        leaf, torch.Tensor) else leaf)
        for p, leaf in zip(treemath.tree_paths(tree),
                           treemath.tree_leaves(tree))]


@pytest.mark.parametrize("name,kw,off,tel", ROUND_KINDS,
                         ids=[b[0] for b in ROUND_KINDS])
def test_on_off_trajectories_bit_identical(task, name, kw, off, tel):
    """telemetry="node" only adds metrics: params, angles, every buffer
    and the generator walk bit for bit as with it off."""
    s_on = _kind_server(task, kw, "node")
    s_off = _kind_server(task, kw, None)
    for _ in range(3):
        m_on, m_off = s_on.step(eval_every=2), s_off.step(eval_every=2)
        for key in off:
            assert m_on[key].tobytes() == m_off[key].tobytes(), key
    assert _state_bytes(s_on.state) == _state_bytes(s_off.state)


def _counting(monkeypatch):
    """Count the round's calls of each kernel wrapper (on the CPU the
    wrappers run their plain versions and count no launch)."""
    calls = {}
    for name in ("weighted_agg", "weighted_agg_q", "weighted_agg_q4",
                 "round_stats", "round_stats_q", "round_stats_q4"):
        real = getattr(tfl, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)

        monkeypatch.setattr(tfl, name, wrapped)
    return calls


@pytest.mark.parametrize("name,kw,off,tel", ROUND_KINDS,
                         ids=[b[0] for b in ROUND_KINDS])
def test_off_never_reaches_telemetry_and_adds_no_kernel_call(
        task, monkeypatch, name, kw, off, tel):
    calls = _counting(monkeypatch)
    s_on = _kind_server(task, kw, "node")
    s_on.run(3, eval_every=1)
    on = dict(calls)
    calls.clear()

    def refuse(*a, **k):
        raise AssertionError("telemetry code reached with telemetry off")

    for fn in ("_telemetry_metrics", "_down_byte_split", "_weight_entropy"):
        monkeypatch.setattr(tfl, fn, refuse)
    s_off = _kind_server(task, kw, None)
    s_off.run(3, eval_every=1)
    assert calls == on
    # the flat round: 2 + 1 a round; sequential: one round_stats a
    # client; the tree engine calls none
    path = kw.get("mode", kw.get("engine"))
    assert sum(on.values()) == {"tree": 0, "sequential": 3 * 6}.get(path,
                                                                     3 * 3)
    assert _state_bytes(s_on.state) == _state_bytes(s_off.state)


# --------------------------------------- (b) every tel/* key against JAX


@pytest.fixture
def exact_tel(monkeypatch):
    """Wrap the shared per-round check: the port's keyset must be the JAX
    round's, and its integer, mask and byte tel/* fields equal, dtype
    included. Returns the tel/* keys seen."""
    seen = set()
    real = test_torch_downlink.assert_state_matches_jax

    def check(st, jst, m, jm, msg, tol=test_torch_downlink.TOL):
        real(st, jst, m, jm, msg, tol)
        assert set(m) == set(jm), (msg, set(m) ^ set(jm))
        for key in EXACT_TEL_KEYS & set(m):
            got, want = m[key].numpy(), np.asarray(jm[key])
            assert got.dtype == want.dtype, (msg, key, got.dtype,
                                             want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f"{msg} {key}")
        seen.update(k for k in m if k.startswith("tel/"))

    monkeypatch.setattr(test_torch_downlink, "assert_state_matches_jax",
                        check)
    return seen


PARTIAL = [[0, 1, 2, 3], [2, 3, 4, 5], [0, 1, 4, 5], [1, 2, 3, 5]]


@pytest.mark.parametrize("cfg_kw", [
    dict(),
    dict(transport="int8", error_feedback=True, downlink="bf16",
         downlink_error_feedback=True),
    dict(transport="int4", group_size=8, downlink="int8",
         downlink_delta=True, downlink_ring=2),
    dict(transport="bf16", downlink="bf16", downlink_delta=True,
         method="fedavg"),
], ids=["f32-f32", "int8ef-bf16ef", "int4-int8delta-ring2",
        "bf16-bf16delta-fedavg"])
def test_parallel_tel_keys_match_jax(exact_tel, cfg_kw):
    """Both port engines against the JAX flat round, 4 of 6 clients."""
    rounds_against_jax(toy_problem(4), 4, dict(telemetry="node", **cfg_kw),
                       PARTIAL, num_clients=6)
    want = TEL_KEYS_SYNC | (TEL_KEYS_DELTA if cfg_kw.get("downlink_delta")
                            else set())
    assert exact_tel == want


def _arrivals(package):
    delays = np.array([[0, 2, 0, 0], [0, 0, 1, 0], [0, 0, 0, 0],
                       [1, 0, 0, 0]], np.int32)
    drops = np.zeros((4, 4), bool)
    drops[0, 3] = True
    mod = repro if package == "jax" else repro_torch
    return mod.fixed_arrival_schedule(delays, drops)


@pytest.mark.parametrize("cfg_kw", [
    dict(buffer_m=2),
    dict(buffer_m=3, transport="int8", error_feedback=True,
         downlink="int8", downlink_delta=True, downlink_ring=2),
], ids=["f32", "int8ef-int8delta"])
def test_buffered_tel_keys_match_jax(exact_tel, cfg_kw):
    """Buffered ticks: attribution by buffer slot, ages, the landed mask,
    occupancy and the byte split over the admitted pulls."""
    rounds_against_jax(toy_problem(4), 4,
                       dict(telemetry="node", aggregation="buffered",
                            staleness_beta=0.5, **cfg_kw),
                       PARTIAL, num_clients=6, make_arrival=_arrivals)
    assert TEL_KEYS_BUFFERED <= exact_tel


def test_sequential_tel_keys_match_jax(exact_tel):
    rounds_against_jax(toy_problem(4), 4,
                       dict(telemetry="node", mode="sequential"), PARTIAL,
                       num_clients=6, engines=("tree",), jax_engine="tree")
    assert exact_tel == TEL_KEYS_SYNC


# ------------------------------------------------------------ (c) streams


def _assert_streams_equal(a, b):
    for kind in ("round", "node", "summary"):
        ea, eb = a.of_type(kind), b.of_type(kind)
        assert len(ea) == len(eb), kind
        for x, y in zip(ea, eb):
            assert x == y, (kind, x, y)


@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_scanned_stream_matches_stepwise_stream(task, engine):
    """The same step and the same adapter: the two modes' streams are
    equal event for event (the reference holds 1e-5; here nothing
    differs at all)."""
    cfg = _cfg(engine=engine)
    k_step, k_scan = sinks.MemorySink(), sinks.MemorySink()
    _server(task, cfg).run(6, eval_every=2, mode="stepwise", sink=k_step)
    _server(task, cfg).run(6, eval_every=2, mode="scanned", block=4,
                           sink=k_scan)
    schema.validate_events(k_step.events)
    schema.validate_events(k_scan.events)
    _assert_streams_equal(k_step, k_scan)
    assert len(k_scan.of_type("round")) == 6
    assert len(k_scan.of_type("node")) == 6 * 6
    names = {e["name"] for e in k_scan.of_type("span")}
    assert names == {"scan_block", "sink_emit"}


def test_partial_final_block_emits_exact_round_count(task):
    sink = sinks.MemorySink()
    _server(task, _cfg()).run(10, eval_every=3, mode="scanned", block=8,
                              sink=sink)
    rounds = sink.of_type("round")
    assert [e["round"] for e in rounds] == list(range(1, 11))
    acc = {e["round"]: e["accuracy"] for e in rounds}
    assert all(acc[r] is not None for r in (3, 6, 9))
    assert all(acc[r] is None for r in acc if r % 3)
    assert [e["round"] for e in sink.of_type("span")
            if e["name"] == "scan_block"] == [0, 8]


def test_telemetry_every_subsamples_rounds(task):
    sink = sinks.MemorySink()
    _server(task, _cfg()).run(8, eval_every=0, mode="scanned", block=4,
                              sink=sink, telemetry_every=3)
    assert [e["round"] for e in sink.of_type("round")] == [3, 6]
    assert len(sink.of_type("node")) == 2 * 6
    assert len(sink.of_type("summary")) == 1


def test_eval_sentinel_is_pinned_and_masked(task):
    assert driver.EVAL_SENTINEL == schema.EVAL_SENTINEL == \
        jschema.EVAL_SENTINEL == -1.0
    m = _server(task, _cfg(telemetry=None)).step(eval_every=0)
    assert float(m["accuracy"]) == schema.EVAL_SENTINEL
    assert schema.mask_accuracy(m["accuracy"]) is None
    with pytest.raises(ValueError, match="sentinel"):
        schema.validate_event({"event": "round", "round": 1, "loss": 1.0,
                               "lr": 0.1, "divergence": 0.0,
                               "accuracy": schema.EVAL_SENTINEL})


def test_buffered_stream_carries_staleness_and_occupancy(task):
    """tests/test_telemetry.py's buffered case: node 0's tick-0 report
    straggles 2 ticks, misses two flushes, and lands at tick 2 aged 2."""
    k, m = 4, 3
    delays = np.zeros((3, k), np.int32)
    delays[0, 0] = 2
    drops = np.zeros((3, k), bool)
    cfg = _cfg(num_clients=k, clients_per_round=k, aggregation="buffered",
               buffer_m=m)
    s = _server(task, cfg, repro_torch.fixed_arrival_schedule(delays, drops))
    sink = sinks.MemorySink()
    s.run(3, eval_every=0, mode="scanned", block=3, sink=sink)
    schema.validate_events(sink.events)
    rounds = sink.of_type("round")
    assert [e["flushed"] for e in rounds] == [1, 1, 1]
    assert all("occupancy" in e and "staleness" in e for e in rounds)
    straggler = {e["round"]: e for e in sink.of_type("node")
                 if e["node"] == 0}
    assert [straggler[r]["landed"] for r in (1, 2, 3)] == [False, False,
                                                           True]
    assert straggler[3]["age"] == 2
    assert straggler[1]["weight"] == straggler[2]["weight"] == 0.0
    assert rounds[2]["staleness"] == pytest.approx(2 / k)
    assert report.check_weight_sums(sink.events) == 3


def test_csv_sink_writes_per_node_rows(tmp_path, task):
    path = str(tmp_path / "telemetry.csv")
    sink = sinks.CSVSink(path)
    _server(task, _cfg()).run(3, eval_every=1, mode="stepwise", sink=sink)
    sink.close()
    with open(path) as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 3 * 6
    assert set(rows[0]) == set(sinks.CSVSink.COLUMNS)
    assert abs(sum(float(r["weight"]) for r in rows if r["round"] == "1")
               - 1.0) < 1e-5


def test_jsonl_stream_passes_the_reference_readers(tmp_path, task):
    """A port JSONL stream validates under the JAX package's own schema,
    its rounds to target through the reference's report equal the
    History's, and scripts/flstat.py reads it."""
    path = str(tmp_path / "telemetry.jsonl")
    sink = sinks.JSONLSink(path)
    cfg = _cfg(engine="flat", transport="int8", error_feedback=True,
               clients_per_round=4, downlink="int8", downlink_delta=True)
    hist = _server(task, cfg).run(12, target_acc=0.15, eval_every=2,
                                  mode="scanned", block=4, sink=sink)
    sink.close()
    events = sinks.load_events(path)
    counts = jschema.validate_events(events)
    assert counts["manifest"] == 1 and counts["summary"] == 1
    man = events[0]
    assert man["schema"] == jschema.SCHEMA_VERSION
    assert man["jax_version"] == "unavailable"
    assert man["config"]["telemetry"] == "node"
    assert man["backend"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert "torch_version" in man["extra"]
    assert hist.rounds_to_target is not None
    assert jreport.rounds_to_target(events, 0.15) == hist.rounds_to_target
    rounds = [e for e in events if e["event"] == "round"]
    for e in rounds:  # the delta split sums to the round's downlink
        assert e["bytes_down"] == e["bytes_down_delta"] + e["bytes_down_full"]
        assert e["bytes_up"] == repro_torch.transport.round_bytes(
            4, 7850, "int8")["up"]
    assert jreport.summarize(events, 0.15)["spans"]["scan_block"]["count"]
    out = subprocess.run(
        [sys.executable, FLSTAT, path, "--target", "0.15", "--validate",
         "--assert-weight-sums", "--nodes"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"rounds_to_15%={hist.rounds_to_target}" in out.stdout
    assert "weight sums ok" in out.stdout


def test_manifest_config_hash_is_the_reference(task):
    cfg = _cfg(transport="int4", group_size=8)
    jcfg = repro.FLConfig(**dataclasses.asdict(cfg))
    man = repro_torch.run_manifest(cfg, extra={"run": "a"})
    jschema.validate_event(man)
    assert man["config_hash"] == jmanifest.config_hash(jcfg)
    assert man["extra"]["run"] == "a"


def test_percentiles_interpolate_linearly():
    assert report._percentile([1.0, 2.0, 3.0, 4.0], 0.50) == 2.5
    assert report._percentile([10.0, 20.0, 30.0, 40.0, 50.0], 0.90) == 46.0
    vals = sorted([0.03, 0.011, 0.8, 0.07, 0.22, 0.013, 0.4])
    for q in (0.5, 0.9, 0.99):
        assert report._percentile(vals, q) == \
            pytest.approx(float(np.percentile(vals, q * 100)))


def test_span_timer_on_the_cpu():
    sink = sinks.MemorySink()
    timer = spans.SpanTimer(sink, profile=True)
    with timer.span("scan_block", round=3):
        timer.sync({"a": torch.ones(2), "b": [torch.zeros(1), 5]})
    with timer.span("scan_block"):
        pass
    assert timer.counts == {"scan_block": 2}
    (ev, ev2) = sink.of_type("span")
    assert ev["round"] == 3 and ev["dur_s"] >= 0 and "round" not in ev2
    jschema.validate_events([repro_torch.run_manifest()] + sink.events)
