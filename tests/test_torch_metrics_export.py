"""The port's Prometheus exposition (``obs/metrics_export.py``) against the
JAX package's, on the CPU: the twins of the JAX package's
``tests/test_obs_plane.py`` render, parse and merge pins.

- ``render`` is byte-equal to the JAX package's on the same counters,
  gauges, histograms and build info (a golden document, a seeded random
  state, any input order), and each package's ``parse`` reads the other's
  text to the same series;
- ``parse`` plus ``histogram_from_series`` rebuild a rendered histogram
  exactly, per label set; ``merge_all`` is exact in any order, through the
  snapshot round trip; mismatched bounds refuse to merge;
- ``metric_name``, ``escape_label_value`` and ``slo_block`` equal the JAX
  package's.
"""

import numpy as np
import pytest

from eeg_dataanalysispackage_tpu.obs import metrics_export as jax_export
from eeg_dataanalysispackage_tpu_torch.obs import metrics_export


def _both(cls_bounds=None):
    """A port and a JAX histogram with the same bounds."""
    if cls_bounds is None:
        return metrics_export.LatencyHistogram(), jax_export.LatencyHistogram()
    return (metrics_export.LatencyHistogram(cls_bounds),
            jax_export.LatencyHistogram(cls_bounds))


def _random_state(seed):
    rng = np.random.default_rng(seed)
    counters = {f"{a}.{b}": float(rng.integers(0, 1000)) if i % 3 else float(rng.random())
                for i, (a, b) in enumerate(zip(rng.choice(["scheduler", "serve", "dedup",
                                                           "fleet", "lease"], 12),
                                               rng.choice(["completed", "shed", "hit",
                                                           "lead", "claims", "x-y z"], 12)))}
    gauges = {"gateway.queue_depth": int(rng.integers(0, 9)),
              "fleet.devices_free": float(rng.integers(0, 4))}
    hists = []
    for tenant in ("", "alice", 'b"o\\b\n'):
        port, jax = _both()
        for ms in rng.exponential(40.0, size=int(rng.integers(1, 30))):
            port.observe(float(ms))
            jax.observe(float(ms))
        labels = {"tenant": tenant} if tenant else {}
        hists.append((labels, port, jax))
    return counters, gauges, hists


def test_render_golden_text():
    """One controlled state renders to exactly this document, in both
    packages."""
    docs = []
    for module in (metrics_export, jax_export):
        h = module.LatencyHistogram((1.0, 10.0))
        for ms in (0.5, 7.0, 99.0):
            h.observe(ms)
        docs.append(module.render(
            counters={"scheduler.completed": 3, "serve.shed": 1},
            gauges={"gateway.queue_depth": 2},
            histograms=[("serve_request_latency_ms", {}, h),
                        ("serve_request_latency_ms", {"tenant": 'ten"a\n'}, h)],
            info={"replica": "gw-a"}))
    assert docs[0] == docs[1] == (
        '# TYPE eeg_tpu_build_info gauge\n'
        'eeg_tpu_build_info{replica="gw-a"} 1\n'
        '# TYPE eeg_tpu_scheduler_completed_total counter\n'
        'eeg_tpu_scheduler_completed_total 3\n'
        '# TYPE eeg_tpu_serve_shed_total counter\n'
        'eeg_tpu_serve_shed_total 1\n'
        '# TYPE eeg_tpu_gateway_queue_depth gauge\n'
        'eeg_tpu_gateway_queue_depth 2\n'
        '# TYPE eeg_tpu_serve_request_latency_ms histogram\n'
        'eeg_tpu_serve_request_latency_ms_bucket{le="1"} 1\n'
        'eeg_tpu_serve_request_latency_ms_bucket{le="10"} 2\n'
        'eeg_tpu_serve_request_latency_ms_bucket{le="+Inf"} 3\n'
        'eeg_tpu_serve_request_latency_ms_sum 106.5\n'
        'eeg_tpu_serve_request_latency_ms_count 3\n'
        'eeg_tpu_serve_request_latency_ms_bucket{le="1",tenant="ten\\"a\\n"} 1\n'
        'eeg_tpu_serve_request_latency_ms_bucket{le="10",tenant="ten\\"a\\n"} 2\n'
        'eeg_tpu_serve_request_latency_ms_bucket{le="+Inf",tenant="ten\\"a\\n"} 3\n'
        'eeg_tpu_serve_request_latency_ms_sum{tenant="ten\\"a\\n"} 106.5\n'
        'eeg_tpu_serve_request_latency_ms_count{tenant="ten\\"a\\n"} 3\n'
    )


@pytest.mark.parametrize("seed", range(4))
def test_render_is_byte_equal_to_jax_and_each_parses_the_other(seed):
    counters, gauges, hists = _random_state(seed)
    port = metrics_export.render(
        counters=counters, gauges=gauges, info={"replica": f"gw-{seed}"},
        histograms=[("serve_request_latency_ms", labels, p) for labels, p, _ in hists])
    jax = jax_export.render(
        counters=dict(reversed(list(counters.items()))), gauges=gauges,
        info={"replica": f"gw-{seed}"},
        histograms=[("serve_request_latency_ms", labels, j) for labels, _, j in hists[::-1]])
    assert port == jax
    assert jax_export.parse(port) == metrics_export.parse(jax) == metrics_export.parse(port)


def test_render_is_deterministic_across_input_order():
    h = metrics_export.LatencyHistogram()
    h.observe(1.0)
    kw = dict(histograms=[("lat_ms", {}, h)], info={"replica": "r"})
    assert (metrics_export.render(counters={"b": 2, "a": 1}, gauges={"y": 0, "x": 9}, **kw)
            == metrics_export.render(counters={"a": 1, "b": 2}, gauges={"x": 9, "y": 0}, **kw))


def test_parse_histogram_round_trip():
    service, tenant = metrics_export.LatencyHistogram(), metrics_export.LatencyHistogram()
    for ms in (0.4, 3.0, 77.0):
        service.observe(ms)
    tenant.observe(600.0)
    text = metrics_export.render(
        counters={"scheduler.completed": 41},
        histograms=[("serve_request_latency_ms", {}, service),
                    ("serve_request_latency_ms", {"tenant": "t0"}, tenant)])
    series = metrics_export.parse(text)
    assert series["eeg_tpu_scheduler_completed_total"] == [({}, 41.0)]
    got = metrics_export.histogram_from_series(series, "eeg_tpu_serve_request_latency_ms",
                                               match={"tenant": None})
    assert (got.counts, got.count, got.sum_us) == (service.counts, service.count,
                                                   service.sum_us)
    got_t = metrics_export.histogram_from_series(series, "eeg_tpu_serve_request_latency_ms",
                                                 match={"tenant": "t0"})
    assert got_t.counts == tenant.counts
    assert metrics_export.histogram_from_series(series, "eeg_tpu_nope") is None
    jax_t = jax_export.histogram_from_series(jax_export.parse(text),
                                             "eeg_tpu_serve_request_latency_ms",
                                             match={"tenant": "t0"})
    assert (jax_t.counts, jax_t.sum_us) == (got_t.counts, got_t.sum_us)


def test_two_replica_merge_is_exact():
    a, b, union = (metrics_export.LatencyHistogram() for _ in range(3))
    for h, values in ((a, (0.2, 1.7, 30.0, 400.0)), (b, (0.9, 2.5, 2.5, 8000.0, 12.0))):
        for ms in values:
            h.observe(ms)
            union.observe(ms)
    for order in ((a, b), (b, a)):
        merged = metrics_export.merge_all(
            metrics_export.LatencyHistogram.from_snapshot(h.snapshot()) for h in order)
        assert (merged.counts, merged.count, merged.sum_us) == (union.counts, union.count,
                                                                union.sum_us)
        assert merged.quantile(99.0) == union.quantile(99.0)
    assert metrics_export.merge_all([]) is None
    with pytest.raises(ValueError):
        a.merge(metrics_export.LatencyHistogram((1.0, 2.0)))


@pytest.mark.parametrize("name", ["scheduler.completed", "9lives", "a-b c:d", " x.y "])
def test_names_and_escapes_equal_jax(name):
    assert metrics_export.metric_name(name) == jax_export.metric_name(name)
    assert metrics_export.metric_name(name, prefix="") == jax_export.metric_name(name, prefix="")
    assert (metrics_export.escape_label_value(name + '\\"\n')
            == jax_export.escape_label_value(name + '\\"\n'))


@pytest.mark.parametrize("requests,target", [
    ({"completed": 100}, 0.98), ({"completed": 100}, 0.999),
    ({"completed": 50, "shed": 50}, 0.999), ({}, 0.999)])
def test_slo_block_equals_jax(requests, target):
    port, jax = _both()
    for ms in [5.0] * 99 + [2000.0]:
        port.observe(ms)
        jax.observe(ms)
    assert (metrics_export.slo_block(port, requests, 50.0, target)
            == jax_export.slo_block(jax, requests, 50.0, target))
