"""Settings the port reads (counterpart of ``quiver_tpu/config.py``).

Kept: the bucketed batch shapes every serving pass is padded to, how many
queued requests one pass may coalesce, the sampler's element-gather mode
and frontier dedup, the feature-store knobs of the budgeted path
(cold-row overlay and paged store), and serving's safeguards and
telemetry (deadlines, bounded lanes, breakers, QoS, the flight recorder,
the SLO objectives and the timeline), the streaming tier (delta
capacity, compaction cadence, the ingest lane) and durability (the WAL,
checkpoints, the replay deadline, the retrace budget and the kernel
build cache), the serving fleet and the mesh tier.  Defaults are the JAX package's, and
each field that JAX reads from the environment reads the same
``QUIVER_TPU_*`` name here, so a deployment's setting means the same to
both packages.  The one default
that differs is where ``gather_mode="auto"`` lands
(:func:`resolve_gather_mode`).

The configuration is built once per process, at first use.
:func:`override` swaps in a changed copy for the length of a ``with``
block, so a test's settings never leak into the next test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

__all__ = ["Config", "get_config", "override", "resolve_dedup",
           "resolve_gather_mode", "resolve_sample_rng",
           "resolve_sampling"]

# element-gather modes of the sampler's hops, besides "pwindow[:U]"
_GATHER_MODES = ("auto", "xla", "lanes", "lanes_fused", "pallas")


def _env(name: str, default, cast=str):
    v = os.environ.get(f"QUIVER_TPU_{name}")
    if v is None:
        return default
    if cast is bool:
        return v not in ("0", "", "false", "False")
    return cast(v)


@dataclass(frozen=True)
class Config:
    serving_buckets: Tuple[int, ...] = (
        8, 16, 32, 64, 128, 256, 512, 1024, 2048
    )
    max_coalesce: int = 8
    # sampler element gathers: "auto" resolves in resolve_gather_mode
    gather_mode: str = field(
        default_factory=lambda: _env("GATHER_MODE", "auto"))
    # sampler uniforms: "auto" resolves in resolve_sample_rng
    sample_rng: str = field(
        default_factory=lambda: _env("SAMPLE_RNG", "auto"))
    # sampler frontier dedup: "auto" resolves in resolve_dedup
    dedup: str = field(default_factory=lambda: _env("DEDUP", "auto"))
    # cold-row overlay: "auto" = off until enable_cold_cache() or the
    # serving lane's auto-enable; "off"/"0" = never; a size ("64M", or
    # rows under cache_unit="rows") enables it when the feature is built
    cold_cache_size: str = field(
        default_factory=lambda: _env("COLD_CACHE_SIZE", "auto"))
    cold_cache_policy: str = field(
        default_factory=lambda: _env("COLD_CACHE_POLICY", "clock"))
    cold_cache_admit: int = field(
        default_factory=lambda: _env("COLD_CACHE_ADMIT", 2, int))
    # paged store: "on" serves budgeted gathers through kernel B5;
    # page_rows = 0 and page_pool = 0 size pages and pool automatically
    feature_paged: str = field(
        default_factory=lambda: _env("FEATURE_PAGED", "off"))
    feature_page_rows: int = field(
        default_factory=lambda: _env("FEATURE_PAGE_ROWS", 0, int))
    feature_page_pool: int = field(
        default_factory=lambda: _env("FEATURE_PAGE_POOL", 0, int))
    # per-request deadline budget in ms (0: no deadlines), bounded-lane
    # capacity and shed watermarks (fractions of capacity: shed above
    # high until drained below low), and each lane's circuit breaker
    # (consecutive failures to open, seconds to a half-open probe,
    # probes admitted)
    serving_deadline_ms: float = field(
        default_factory=lambda: _env("SERVING_DEADLINE_MS", 0.0, float))
    serving_queue_depth: int = field(
        default_factory=lambda: _env("SERVING_QUEUE_DEPTH", 1024, int))
    serving_queue_high_watermark: float = field(
        default_factory=lambda: _env("SERVING_QUEUE_HIGH_WATERMARK", 0.9,
                                     float))
    serving_queue_low_watermark: float = field(
        default_factory=lambda: _env("SERVING_QUEUE_LOW_WATERMARK", 0.5,
                                     float))
    serving_breaker_failures: int = field(
        default_factory=lambda: _env("SERVING_BREAKER_FAILURES", 5, int))
    serving_breaker_reset_s: float = field(
        default_factory=lambda: _env("SERVING_BREAKER_RESET_S", 30.0, float))
    serving_breaker_probes: int = field(
        default_factory=lambda: _env("SERVING_BREAKER_PROBES", 1, int))
    # multi-tenant QoS, off by default: classes "name:rate=R,burst=B,
    # weight=W,priority=P" joined by ";" (the tenant-label allowlist);
    # unlabelled traffic maps to qos_default_tenant.  The admit window
    # holds a coalesced device pass open for late arrivals; the quantum
    # is the fair lanes' refill in ids a round per unit weight; the
    # ladder steps down after breach_ticks breaching SLO ticks and back
    # up after recover_ticks healthy ones
    qos_enabled: bool = field(
        default_factory=lambda: _env("QOS_ENABLED", False, bool))
    qos_tenants: str = field(
        default_factory=lambda: _env(
            "QOS_TENANTS",
            "gold:rate=200,burst=50,weight=8,priority=3;"
            "silver:rate=100,burst=25,weight=4,priority=2;"
            "bronze:rate=50,burst=15,weight=2,priority=1;"
            "ingest:rate=100,burst=50,weight=1,priority=0"))
    qos_default_tenant: str = field(
        default_factory=lambda: _env("QOS_DEFAULT_TENANT", "bronze"))
    qos_ingest_tenant: str = field(
        default_factory=lambda: _env("QOS_INGEST_TENANT", "ingest"))
    qos_admit_window_ms: float = field(
        default_factory=lambda: _env("QOS_ADMIT_WINDOW_MS", 2.0, float))
    qos_quantum: int = field(
        default_factory=lambda: _env("QOS_QUANTUM", 64, int))
    qos_degrade_fanout_frac: float = field(
        default_factory=lambda: _env("QOS_DEGRADE_FANOUT_FRAC", 0.5, float))
    qos_breach_ticks: int = field(
        default_factory=lambda: _env("QOS_BREACH_TICKS", 2, int))
    qos_recover_ticks: int = field(
        default_factory=lambda: _env("QOS_RECOVER_TICKS", 2, int))
    # flight recorder: retained records, and the e2e latency above which
    # a healthy request counts as slow and is kept
    flightrec_capacity: int = field(
        default_factory=lambda: _env("FLIGHTREC_CAPACITY", 256, int))
    flightrec_slow_ms: float = field(
        default_factory=lambda: _env("FLIGHTREC_SLOW_MS", 100.0, float))
    # SLO objectives: p99 e2e ceiling, error-ratio ceiling, overlay
    # hit-rate floor (0: off), and the watchdog's interval
    slo_p99_ms: float = field(
        default_factory=lambda: _env("SLO_P99_MS", 250.0, float))
    slo_error_ratio: float = field(
        default_factory=lambda: _env("SLO_ERROR_RATIO", 0.01, float))
    slo_coldcache_hit_floor: float = field(
        default_factory=lambda: _env("SLO_COLDCACHE_HIT_FLOOR", 0.0, float))
    slo_interval_s: float = field(
        default_factory=lambda: _env("SLO_INTERVAL_S", 5.0, float))
    # timeline: events a thread's ring holds before it overwrites its
    # oldest
    timeline_ring_capacity: int = field(
        default_factory=lambda: _env("TIMELINE_RING_CAPACITY", 8192, int))
    # streaming tier (stream/): pending delta edges before ingestion
    # folds, the compactor's cadence (seconds between periodic folds; the
    # watermark folds early once that fraction of the capacity is
    # pending), and the ingest lane (depth, its deadline class, 0 for
    # none, and its shed priority)
    stream_delta_capacity: int = field(
        default_factory=lambda: _env("STREAM_DELTA_CAPACITY", 65536, int))
    stream_compact_interval_s: float = field(
        default_factory=lambda: _env("STREAM_COMPACT_INTERVAL_S", 30.0,
                                     float))
    stream_compact_watermark: float = field(
        default_factory=lambda: _env("STREAM_COMPACT_WATERMARK", 0.75,
                                     float))
    stream_ingest_depth: int = field(
        default_factory=lambda: _env("STREAM_INGEST_DEPTH", 256, int))
    stream_ingest_deadline_ms: float = field(
        default_factory=lambda: _env("STREAM_INGEST_DEADLINE_MS", 0.0,
                                     float))
    stream_ingest_priority: int = field(
        default_factory=lambda: _env("STREAM_INGEST_PRIORITY", 1, int))
    # durability (recovery/): the root of the WAL and checkpoints ("":
    # none), the WAL's fsync policy ("always", "batch" or "off") and its
    # segment and batch sizes, checkpoint cadence and retention, the
    # replay deadline (0: none), the builds a subsystem may make after
    # seal() (-1: count, never raise), and the directory the kernel and
    # native libraries are built into and found in ("": the package's
    # build directory)
    recovery_dir: str = field(
        default_factory=lambda: _env("RECOVERY_DIR", ""))
    recovery_fsync: str = field(
        default_factory=lambda: _env("RECOVERY_FSYNC", "always"))
    recovery_segment_bytes: int = field(
        default_factory=lambda: _env("RECOVERY_SEGMENT_BYTES", 4 << 20, int))
    recovery_batch_bytes: int = field(
        default_factory=lambda: _env("RECOVERY_BATCH_BYTES", 1 << 16, int))
    recovery_checkpoint_interval_s: float = field(
        default_factory=lambda: _env("RECOVERY_CHECKPOINT_INTERVAL_S", 60.0,
                                     float))
    recovery_checkpoint_keep: int = field(
        default_factory=lambda: _env("RECOVERY_CHECKPOINT_KEEP", 2, int))
    recovery_deadline_s: float = field(
        default_factory=lambda: _env("RECOVERY_DEADLINE_S", 0.0, float))
    recovery_retrace_budget: int = field(
        default_factory=lambda: _env("RECOVERY_RETRACE_BUDGET", -1, int))
    recovery_cache_dir: str = field(
        default_factory=lambda: _env("RECOVERY_CACHE_DIR", ""))
    # the serving fleet (``fleet/``): the membership directory, the
    # consistent-hash ring's partitions and virtual nodes, heartbeat
    # cadence and timeout, the router's re-dispatch budget, the QoS
    # priority at or above which a tenant routes by two choices, the
    # per-dispatch timeout, WAL shipping's poll and abort holdback, and
    # the staleness (in WAL records) past which a follower is not current
    fleet_dir: str = field(default_factory=lambda: _env("FLEET_DIR", ""))
    fleet_partitions: int = field(
        default_factory=lambda: _env("FLEET_PARTITIONS", 8, int))
    fleet_vnodes: int = field(
        default_factory=lambda: _env("FLEET_VNODES", 64, int))
    fleet_heartbeat_s: float = field(
        default_factory=lambda: _env("FLEET_HEARTBEAT_S", 0.5, float))
    fleet_heartbeat_timeout_s: float = field(
        default_factory=lambda: _env("FLEET_HEARTBEAT_TIMEOUT_S", 3.0,
                                     float))
    fleet_route_retries: int = field(
        default_factory=lambda: _env("FLEET_ROUTE_RETRIES", 2, int))
    fleet_hot_priority: int = field(
        default_factory=lambda: _env("FLEET_HOT_PRIORITY", 3, int))
    fleet_request_timeout_s: float = field(
        default_factory=lambda: _env("FLEET_REQUEST_TIMEOUT_S", 1.0, float))
    fleet_ship_poll_ms: float = field(
        default_factory=lambda: _env("FLEET_SHIP_POLL_MS", 20.0, float))
    fleet_ship_grace_ms: float = field(
        default_factory=lambda: _env("FLEET_SHIP_GRACE_MS", 250.0, float))
    fleet_max_staleness_lsn: int = field(
        default_factory=lambda: _env("FLEET_MAX_STALENESS_LSN", 1024, int))
    # the fleet's observability plane (``fleet/federation.py``): trace
    # propagation and metrics federation (off: the request path pays one
    # config check), the scrape cadence, the router's hop-record ring and
    # the eligible-replica floor of the fleet SLO watchdog
    fleet_federation: str = field(
        default_factory=lambda: _env("FLEET_FEDERATION", "off"))
    fleet_scrape_interval_s: float = field(
        default_factory=lambda: _env("FLEET_SCRAPE_INTERVAL_S", 0.5, float))
    fleet_trace_ring: int = field(
        default_factory=lambda: _env("FLEET_TRACE_RING", 512, int))
    fleet_min_eligible: int = field(
        default_factory=lambda: _env("FLEET_MIN_ELIGIBLE", 1, int))
    # the fleet's autonomy, each off by default (no thread, no metric key
    # when off): fenced leader election (claim poll, the per-rank claim
    # stagger, how often a fenced writer re-reads the claims: 0 = every
    # append), socket WAL shipping, and the autoscaler (its tick, replica
    # bounds, cooldown, the rate one replica is planned at, the forecast
    # lead and the hysteresis band)
    fleet_election: str = field(
        default_factory=lambda: _env("FLEET_ELECTION", "off"))
    fleet_election_poll_s: float = field(
        default_factory=lambda: _env("FLEET_ELECTION_POLL_S", 0.25, float))
    fleet_election_stagger_s: float = field(
        default_factory=lambda: _env("FLEET_ELECTION_STAGGER_S", 0.5, float))
    fleet_election_fence_recheck_s: float = field(
        default_factory=lambda: _env("FLEET_ELECTION_FENCE_RECHECK_S", 0.05,
                                     float))
    fleet_walstream: str = field(
        default_factory=lambda: _env("FLEET_WALSTREAM", "off"))
    fleet_walstream_port: int = field(
        default_factory=lambda: _env("FLEET_WALSTREAM_PORT", 0, int))
    fleet_autoscaler: str = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER", "off"))
    fleet_autoscaler_interval_s: float = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER_INTERVAL_S", 1.0,
                                     float))
    fleet_autoscaler_min: int = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER_MIN", 1, int))
    fleet_autoscaler_max: int = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER_MAX", 8, int))
    fleet_autoscaler_cooldown_s: float = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER_COOLDOWN_S", 30.0,
                                     float))
    fleet_autoscaler_rps_per_replica: float = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER_RPS_PER_REPLICA",
                                     200.0, float))
    fleet_autoscaler_horizon_s: float = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER_HORIZON_S", 10.0,
                                     float))
    fleet_autoscaler_up_ratio: float = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER_UP_RATIO", 0.8, float))
    fleet_autoscaler_down_ratio: float = field(
        default_factory=lambda: _env("FLEET_AUTOSCALER_DOWN_RATIO", 0.5,
                                     float))
    # mesh-native sharded serving (``mesh/``): the row-range shards one
    # logical replica spans (0 = off: nothing of the mesh tier is built),
    # the shard group this process announces, its shard index in the
    # group, and each shard's frame pool in pages (0 = the whole range)
    mesh_shards: int = field(
        default_factory=lambda: _env("MESH_SHARDS", 0, int))
    mesh_group: str = field(
        default_factory=lambda: _env("MESH_GROUP", "", str))
    mesh_shard_index: int = field(
        default_factory=lambda: _env("MESH_SHARD_INDEX", 0, int))
    mesh_pool_pages: int = field(
        default_factory=lambda: _env("MESH_POOL_PAGES", 0, int))


_lock = threading.Lock()
_config: Optional[Config] = None


# config is frozen once per process, so anything read off it is
# process-lifetime-finite: cache keys built from config attributes
# cannot blow up executable cardinality.
# quiverlint: bucketed[config is frozen once per process]
def get_config() -> Config:
    global _config
    cfg = _config
    if cfg is None:
        with _lock:
            if _config is None:
                _config = Config()
            cfg = _config
    return cfg


def update(**kwargs) -> Config:
    """Change some fields for the rest of the process (or of the
    enclosing :func:`override` block); an unknown field raises
    ``AttributeError``.  Returns the configuration now in force."""
    global _config
    prev = get_config()
    for k in kwargs:
        if not hasattr(prev, k):
            raise AttributeError(f"unknown config field {k!r}")
    with _lock:
        _config = dataclasses.replace(_config or prev, **kwargs)
        return _config


@contextlib.contextmanager
def override(**changes) -> Iterator[Config]:
    """Run a block with some fields changed; the previous configuration
    comes back when the block ends, however it ends."""
    global _config
    prev = get_config()
    new = dataclasses.replace(prev, **changes)
    with _lock:
        _config = new
    try:
        yield new
    finally:
        with _lock:
            _config = prev


def _validate_gather_mode(mode) -> None:
    # imported here: ops/ imports this module
    from .ops.blockgather import parse_u_mode

    if mode in _GATHER_MODES:
        return
    for prefix in ("pwindow", "blocked"):
        if isinstance(mode, str) and mode.startswith(prefix):
            parse_u_mode(mode, prefix)
            return
    raise ValueError(
        f"gather_mode must be one of {_GATHER_MODES}, 'pwindow[:U]' or "
        f"'blocked[:U]', got {mode!r}")


def resolve_gather_mode(gather_mode: str,
                        sample_rng: Optional[str] = None) -> str:
    """The element-gather mode a sampler runs.

    An explicit mode wins, then ``QUIVER_TPU_GATHER_MODE``; ``"auto"``
    resolves to ``"pwindow"``, the fused hop of kernel B1.  (JAX resolves
    it to ``"lanes"`` on an accelerator, a choice made against the TPU's
    serialized scalar gather, which the card does not have.)  Every mode
    draws the same neighbours under either RNG; ``pwindow``'s ``U`` sizes
    a TPU VMEM window and ``blocked``'s a block of TPU rows; both are
    accepted but unused (``ops/blockgather.py``).

    ``sample_rng`` is the caller's raw argument, as in JAX
    (``quiver_tpu/config.py:582-604``): ``"pwindow"`` fuses the counter
    hash, so an ``"auto"`` that lands on ``"pwindow"`` becomes
    ``"blocked"`` (its key-capable counterpart, the same draws; on the
    card a uniform ``"blocked"`` hop under the key is B1's threefry
    instance, ``ops/sample.py::run_hop``) when the RNG is ``"key"``: an
    explicit ``"key"`` over a ``"pwindow"`` pin, as in JAX, and an
    explicit or pinned ``"key"`` over the port's default.  An
    explicit ``"pwindow"`` is never rewritten: with ``"key"`` it raises at
    the op."""
    _validate_gather_mode(gather_mode)
    if gather_mode != "auto":
        return gather_mode
    cfg = get_config()
    _validate_gather_mode(cfg.gather_mode)
    if cfg.gather_mode != "auto":
        keyed, resolved = sample_rng == "key", cfg.gather_mode
    else:
        rng = sample_rng if sample_rng not in (None, "auto") \
            else cfg.sample_rng
        keyed, resolved = rng == "key", "pwindow"
    if keyed and resolved.startswith("pwindow"):
        return "blocked" + resolved[len("pwindow"):]
    return resolved


def resolve_sampling(gather_mode: str,
                     sample_rng: str) -> Tuple[str, str]:
    """The gather mode and the RNG a sampler runs, from the caller's raw
    arguments, in JAX's order (``quiver_tpu/config.py:582-604``): the
    mode first, since a ``"key"`` RNG turns the default ``"pwindow"``
    into ``"blocked"`` (:func:`resolve_gather_mode`), then the RNG under
    the resolved mode (:func:`resolve_sample_rng`).  Every sampling entry
    resolves through here."""
    gm = resolve_gather_mode(gather_mode, sample_rng)
    return gm, resolve_sample_rng(sample_rng, gm)


def resolve_dedup(dedup: str) -> str:
    """The frontier dedup a sampler runs: an explicit ``"none"`` or
    ``"hop"`` wins, then ``QUIVER_TPU_DEDUP``; ``"auto"`` is ``"none"``,
    the positional pipeline, as in the JAX package (which may also read
    a tuned file; the port does not)."""
    if dedup not in ("auto", "none", "hop"):
        raise ValueError(f"dedup must be auto|none|hop, got {dedup!r}")
    if dedup != "auto":
        return dedup
    cfg = get_config().dedup
    return "none" if cfg == "auto" else resolve_dedup(cfg)


def resolve_sample_rng(sample_rng: str,
                       gather_mode: Optional[str] = None) -> str:
    """The uniform source of the sampling hops: ``"hash"`` (the counter
    hash, kernel B1's) or ``"key"`` (JAX's threefry
    ``jax.random.uniform`` of each hop key, ``ops/threefry.py``).

    An explicit ``"hash"`` or ``"key"`` wins; ``"auto"`` reads
    ``QUIVER_TPU_SAMPLE_RNG`` (``Config.sample_rng``) and is ``"hash"``
    when that is ``"auto"`` too: JAX's default on an accelerator, and the
    port's backend is the card.  ``gather_mode`` is the resolved mode, as
    in JAX (``quiver_tpu/config.py:473-520``): under ``"pwindow"``, which
    fuses the hash, ``"auto"`` is ``"hash"``, and a pinned ``"key"`` warns
    that it is overridden; an explicit ``"key"`` returns here and raises
    at the op."""
    if sample_rng not in ("auto", "key", "hash"):
        raise ValueError(f"sample_rng must be auto|key|hash, got "
                         f"{sample_rng!r}")
    if sample_rng != "auto":
        return sample_rng
    pinned = get_config().sample_rng
    if pinned not in ("auto", "key", "hash"):
        raise ValueError(f"sample_rng must be auto|key|hash, got "
                         f"{pinned!r}")
    if gather_mode is not None and gather_mode.startswith("pwindow"):
        if pinned == "key":
            import warnings

            warnings.warn(
                "sample_rng='key' pinned via QUIVER_TPU_SAMPLE_RNG is "
                "overridden to 'hash': gather_mode='pwindow' fuses the "
                "counter-hash RNG in-kernel. Pass sample_rng='key' "
                "explicitly to get a hard error, or pick a "
                "'blocked:U'/'lanes' gather mode to keep key-based "
                "draws.", stacklevel=2)
        return "hash"
    return "hash" if pinned == "auto" else pinned
