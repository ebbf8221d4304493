"""Prometheus text-format rendering of the serving stats summary.

The JAX package's ``obs/prometheus.py``, lifted (it imports nothing of JAX).

``GET /metrics`` on the front door is a pure projection of
:meth:`waternet_tpu_torch.serving.stats.ServingStats.summary` — the exact dict
``GET /stats`` returns — into the Prometheus text exposition format
(version 0.0.4). One vocabulary, two wire formats: every counter and
gauge here is cross-checkable against the ``/stats`` JSON field it came
from, and tests/test_obs.py pins that equivalence.

Mapping conventions:

* monotone counts (``requests``, ``shed_count``, stream frame counts,
  per-tier/per-replica counts) become ``counter`` samples with the
  conventional ``_total`` suffix;
* instantaneous values (queue depth, occupancy, images/sec, recovery
  max) become ``gauge`` samples;
* quantile summaries (``latency_ms``, stream ``frame_latency_ms``)
  become one sample per quantile with a ``quantile`` label, mirroring
  the Prometheus summary type;
* replica health is one ``waternet_replica_health`` sample per replica
  with ``tier``/``replica``/``state`` labels and value 1 — the state is
  a label so dashboards can group on it without a state→number codec;
* the windowed latency distribution is a TRUE Prometheus ``histogram``
  (cumulative ``le`` buckets + ``_sum`` + ``_count``), rendered from
  the ``window.latency_hist_ms`` block — burn rates and heatmaps need
  the distribution, not pre-baked quantiles; windowed quantiles and
  rates ride alongside as gauges, and the armed SLO engine (if any)
  exports per-objective state (ok=0 / warn=1 / page=2) and short/long
  burn gauges.

No external client library: the text format is a few lines of string
assembly, and the repo's no-new-deps rule holds.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    if isinstance(value, int):
        return str(value)
    return repr(float(value))


def _escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _sample(name: str, labels: Optional[Dict[str, object]], value) -> str:
    if labels:
        body = ",".join(
            f'{k}="{_escape(v)}"' for k, v in labels.items()
        )
        return f"{name}{{{body}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


class _Writer:
    def __init__(self):
        self.lines: List[str] = []

    def metric(
        self,
        name: str,
        mtype: str,
        help_text: str,
        samples: Iterable[Tuple[Optional[Dict[str, object]], object]],
    ) -> None:
        rows = [_sample(name, labels, value) for labels, value in samples]
        if not rows:
            return
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} {mtype}")
        self.lines.extend(rows)

    def one(self, name, mtype, help_text, value, labels=None) -> None:
        self.metric(name, mtype, help_text, [(labels, value)])

    def histogram(self, name: str, help_text: str, block: dict) -> None:
        """A true Prometheus histogram from an ``obs.window``
        ``histogram_block``: cumulative ``_bucket`` samples per ``le``
        bound, the implicit ``+Inf`` bucket, ``_sum`` and ``_count``."""
        self.lines.append(f"# HELP {name} {help_text}")
        self.lines.append(f"# TYPE {name} histogram")
        for le, cum in zip(block["le"], block["cumulative"]):
            self.lines.append(
                _sample(f"{name}_bucket", {"le": _fmt(float(le))}, cum))
        self.lines.append(
            _sample(f"{name}_bucket", {"le": "+Inf"}, block["count"]))
        self.lines.append(_sample(f"{name}_sum", None, block["sum"]))
        self.lines.append(_sample(f"{name}_count", None, block["count"]))

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


#: Alert states as exported gauge values (grouping and alerting both
#: want a total order: paging > warning > healthy).
SLO_STATE_VALUES = {"ok": 0, "warn": 1, "page": 2}


def render_prometheus(summary: dict) -> str:
    """Render a ``ServingStats.summary()`` dict as Prometheus text."""
    w = _Writer()

    w.one("waternet_requests_total", "counter",
          "Requests resolved by the batcher.", summary["requests"])
    w.one("waternet_batches_total", "counter",
          "Batched device launches.", summary["batches"])
    w.metric(
        "waternet_request_latency_ms", "gauge",
        "End-to-end request latency quantiles (ms).",
        [({"quantile": q}, summary["latency_ms"][p])
         for q, p in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))],
    )
    w.one("waternet_batch_occupancy", "gauge",
          "Mean filled fraction of launched batches.",
          summary["batch_occupancy"])
    w.one("waternet_padding_overhead", "gauge",
          "Mean padded-pixels overhead of launched batches.",
          summary["padding_overhead"])
    w.one("waternet_compiles_total", "counter",
          "Bucket executable compiles.", summary["compiles"])
    w.one("waternet_fallback_native_shapes_total", "counter",
          "Requests served at native shape outside the ladder.",
          summary["fallback_native_shapes"])
    w.one("waternet_shed_total", "counter",
          "Requests shed by admission control.", summary["shed_count"])
    w.one("waternet_deadline_expired_total", "counter",
          "Requests dropped after their deadline expired.",
          summary["deadline_expired"])
    w.one("waternet_retried_total", "counter",
          "Requests re-dispatched after a replica fault.",
          summary["retried"])
    w.one("waternet_downgraded_total", "counter",
          "Requests served on a lower tier than requested.",
          summary["downgraded"])
    w.one("waternet_nan_outputs_total", "counter",
          "Batches rejected by the output guard.",
          summary["nan_outputs"])
    w.one("waternet_quarantines_total", "counter",
          "Replica quarantine transitions.", summary["quarantines"])
    w.one("waternet_reintegrations_total", "counter",
          "Replica reintegrations after re-warm.",
          summary["reintegrations"])
    w.one("waternet_recovery_sec_max", "gauge",
          "Slowest observed quarantine→healthy recovery (s).",
          summary["recovery_sec_max"])
    w.one("waternet_queue_depth", "gauge",
          "Current batcher queue depth.", summary["queue_depth"])
    # --- adaptive coalescing (.get keeps older summaries legal)
    w.metric(
        "waternet_eff_wait_ms", "gauge",
        "Live effective coalescing window per tier (ms) — the "
        "max_wait_ms cap under --coalesce fixed, the controller's "
        "load-aware window under adaptive.",
        [({"tier": tier}, v)
         for tier, v in sorted(summary.get("eff_wait_ms", {}).items())],
    )
    w.one("waternet_queue_depth_mean", "gauge",
          "Mean queue depth sampled at admissions.",
          summary["queue_depth_mean"])
    w.one("waternet_queue_depth_max", "gauge",
          "Max queue depth sampled at admissions.",
          summary["queue_depth_max"])
    w.one("waternet_replicas", "gauge",
          "Configured replica count.", summary["replicas"])
    w.one("waternet_images_per_sec", "gauge",
          "Resolved-request throughput since stats start.",
          summary["images_per_sec"])
    w.one("waternet_load_imbalance", "gauge",
          "Max/mean per-replica request ratio.",
          summary["load_imbalance"])

    w.metric(
        "waternet_replica_health", "gauge",
        "Replica health: one sample per replica, state as a label.",
        [({"tier": tier, "replica": idx, "state": state}, 1)
         for tier, reps in sorted(summary["replica_health"].items())
         for idx, state in sorted(reps.items())],
    )
    w.metric(
        "waternet_tier_requests_total", "counter",
        "Requests resolved per tier.",
        [({"tier": tier}, t["requests"])
         for tier, t in sorted(summary["tiers"].items())],
    )
    w.metric(
        "waternet_tier_batches_total", "counter",
        "Batches launched per tier.",
        [({"tier": tier}, t["batches"])
         for tier, t in sorted(summary["tiers"].items())],
    )

    s = summary["streams"]
    w.one("waternet_streams_opened_total", "counter",
          "Stream sessions accepted.", s["opened"])
    w.one("waternet_streams_refused_total", "counter",
          "Stream sessions refused at admission.", s["refused"])
    w.one("waternet_stream_frames_in_total", "counter",
          "Frames read off stream sockets.", s["frames_in"])
    w.one("waternet_stream_frames_delivered_total", "counter",
          "Frames delivered downstream.", s["frames_delivered"])
    w.one("waternet_stream_frames_reused_total", "counter",
          "Frames answered from the cached enhanced frame by temporal "
          "gating (never computed).", s.get("frames_reused", 0))
    w.one("waternet_stream_frames_dropped_total", "counter",
          "Frames dropped by window enforcement.", s["frames_dropped"])
    w.one("waternet_stream_frames_out_of_budget_total", "counter",
          "Delivered frames that missed their latency budget.",
          s["frames_out_of_budget"])
    w.one("waternet_stream_downgrades_total", "counter",
          "Stream frames served on a downgraded tier.", s["downgrades"])
    w.one("waternet_active_streams", "gauge",
          "Currently open stream sessions.", s["active_streams"])
    w.metric(
        "waternet_stream_session_p99_ms", "gauge",
        "Per-session frame-latency p99 (ms).",
        [({"stream": sid}, v)
         for sid, v in sorted(s["per_session_p99_ms"].items())],
    )
    w.metric(
        "waternet_stream_frame_latency_ms", "gauge",
        "Stream frame latency quantiles (ms).",
        [({"quantile": "0.5"}, s["frame_latency_ms"]["p50"]),
         ({"quantile": "0.99"}, s["frame_latency_ms"]["p99"])],
    )

    # --- /enhance response cache (.get keeps older summaries legal)
    cache = summary.get("cache")
    if cache:
        w.one("waternet_response_cache_enabled", "gauge",
              "1 when the content-addressed /enhance cache is armed.",
              cache["enabled"])
        w.one("waternet_response_cache_hits_total", "counter",
              "Responses replayed from the content-addressed cache.",
              cache["hits"])
        w.one("waternet_response_cache_misses_total", "counter",
              "Cache lookups that fell through to compute.",
              cache["misses"])
        w.one("waternet_response_cache_evictions_total", "counter",
              "Entries evicted by the LRU capacity bound.",
              cache["evictions"])
        w.one("waternet_response_cache_entries", "gauge",
              "Entries currently cached.", cache["entries"])
        w.one("waternet_response_cache_generation", "gauge",
              "Params generation (bumped by each /admin/reload "
              "invalidation).", cache["generation"])

    # --- event-loop lag (--obs-loop-lag; .get keeps older summaries legal)
    loop_lag = summary.get("loop_lag")
    if loop_lag:
        w.one("waternet_loop_lag_enabled", "gauge",
              "1 when the Handle._run loop-lag sampler is armed "
              "(--obs-loop-lag).", loop_lag["enabled"])
        w.one("waternet_loop_lag_max_ms", "gauge",
              "Longest single event-loop callback observed, ms.",
              loop_lag["max_ms"])
        w.one("waternet_loop_lag_p99_ms", "gauge",
              "p99 event-loop callback wall time over the retained "
              "sample window, ms.", loop_lag["p99_ms"])
        w.one("waternet_loop_callbacks_total", "counter",
              "Event-loop callbacks timed by the sampler.",
              loop_lag["callbacks"])
        w.one("waternet_loop_stalls_total", "counter",
              "Callbacks past the sampler's stall threshold (infinite "
              "by default in production: gauges only).",
              loop_lag["stalls"])

    per_replica = summary["per_replica"]
    w.metric(
        "waternet_replica_requests_total", "counter",
        "Requests resolved per replica.",
        [({"replica": r["replica"]}, r["requests"]) for r in per_replica],
    )
    w.metric(
        "waternet_replica_batches_total", "counter",
        "Batches launched per replica.",
        [({"replica": r["replica"]}, r["batches"]) for r in per_replica],
    )
    w.metric(
        "waternet_replica_busy_seconds_total", "counter",
        "Cumulative device-busy wall time per replica (s).",
        [({"replica": r["replica"]}, r["busy_sec"]) for r in per_replica],
    )

    # --- sliding windows + SLO (.get keeps older summaries legal)
    win = summary.get("window")
    if win:
        w.histogram(
            "waternet_request_latency_window_ms",
            f"Request latency over the trailing {win['long_window_sec']:g}s "
            "window (ms).",
            win["latency_hist_ms"],
        )
        w.metric(
            "waternet_request_latency_window_quantile_ms", "gauge",
            f"Windowed ({win['window_sec']:g}s) latency quantiles (ms).",
            [({"quantile": q}, win["latency_ms"][p])
             for q, p in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))],
        )
        w.metric(
            "waternet_tier_latency_window_p99_ms", "gauge",
            "Windowed per-tier latency p99 (ms).",
            [({"tier": tier}, q["p99"])
             for tier, q in sorted(win["tiers"].items())],
        )
        w.one("waternet_requests_per_sec_window", "gauge",
              "Completed-request rate over the trailing window.",
              win["requests_per_sec"])
        w.one("waternet_shed_per_sec_window", "gauge",
              "Shed rate over the trailing window.", win["shed_per_sec"])
        w.one("waternet_error_rate_window", "gauge",
              "Error fraction over the trailing window.", win["error_rate"])
        w.one("waternet_queue_depth_window_p99", "gauge",
              "Windowed queue-depth p99 at batch launch.",
              win["queue_depth"]["p99"])

    slo = summary.get("slo")
    if slo:
        w.metric(
            "waternet_slo_state", "gauge",
            "Per-objective alert state (0=ok, 1=warn, 2=page).",
            [({"objective": o["objective"]},
              SLO_STATE_VALUES.get(o["state"], 0))
             for o in slo["objectives"]],
        )
        w.metric(
            "waternet_slo_burn", "gauge",
            "Per-objective burn rate (1.0 = burning budget exactly).",
            [({"objective": o["objective"], "window": wname}, o[key])
             for o in slo["objectives"]
             for wname, key in (("short", "short_burn"),
                                ("long", "long_burn"))],
        )
        w.one("waternet_slo_degraded", "gauge",
              "1 when any SLO objective is paging.",
              1 if slo["grade"] == "degraded" else 0)
    return w.text()
