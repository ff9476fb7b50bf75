"""graftwan link shaping: declarative per-host-pair WAN specs, compiled
to ``tc qdisc netem`` for remote fleets, with a root-free userspace TCP
proxy fallback so local and CI runs exercise the identical plan schema.

The reference's headline artifact is a 5-region matrix (SURVEY.md §3.5 /
§6); HotStuff's responsiveness claim only means something under measured
WAN latency.  A WAN spec names directed links between committee
endpoints and the shape of each:

Endpoints
    ``node:<i>``   replica i (boot-order index locally, host index on a
                   fleet)
    ``sidecar``    the shared verify sidecar (shaping this link models a
                   slow or partially partitioned accelerator service)
    ``client``     the load generators
    ``*``          wildcard source — every other endpoint (src only)

Shape fields (any subset; a shapeless link is legal — it exists purely
as a ``link:<name>`` partition target for fault plans)
    ``latency_ms``  one-way added delay          ``jitter_ms`` +- spread
    ``loss_pct``    loss percentage (0..100)     ``rate_mbit`` rate cap

Links are DIRECTED (``src>dst``): an asymmetric spec — e.g. node:0 can
reach the sidecar but not vice versa — models the partial partitions of
a shared sidecar that symmetric netem recipes cannot express.  An
optional ``default`` shape applies to every host pair without an
explicit link on remote fleets.

Two executors, one schema:

* ``tc_setup_commands`` compiles the spec into per-host ``tc`` command
  lists (root prio qdisc, one netem band + dst-ip u32 filter per link)
  for the ssh transport; ``tc_partition_commands``/``tc_heal_commands``
  drive mid-run ``link:<name>`` fault-plan events via ``netem loss
  100%`` and a restore of the spec shape.
* ``WanProxy`` is the root-free fallback: a threaded TCP proxy applying
  delay/jitter/loss/rate per forwarded chunk, with ``partition()`` /
  ``heal()`` for the same plan events.  Loss on a byte stream cannot
  drop single segments (TCP would just retransmit), so a lossy chunk
  drops the CONNECTION — the visible failure mode loss actually causes
  a consensus link (stalled TCP, reconnect) — and rate is enforced by
  sleeping the pump to the token rate.
"""

from __future__ import annotations

import json
import os
import random
import re
import socket
import threading
import time
from dataclasses import dataclass, field

NODE_RE = re.compile(r"^node:(\d+)$")
SIDECAR = "sidecar"
CLIENT = "client"
WILDCARD = "*"

# The first prio band free for netem attachment: bands 1..3 are the
# default priomap's, per-link bands count up from here.  The prio
# qdisc hard-caps at 16 bands, so one host's egress can carry at most
# 16 - 3 shaped links — enforced at compile time (host_links), which
# runs in the remote pre-flight before any host boots.
_FIRST_BAND = 4
_MAX_BANDS = 16


class WanError(ValueError):
    """Malformed or physically unrealizable WAN spec."""


def _endpoint_ok(ep: str, allow_wildcard=False) -> bool:
    if ep == WILDCARD:
        return allow_wildcard
    return ep in (SIDECAR, CLIENT) or NODE_RE.match(ep) is not None


@dataclass(frozen=True)
class LinkShape:
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    loss_pct: float = 0.0
    rate_mbit: float = 0.0   # 0 = uncapped

    def validate(self, label: str):
        for key in ("latency_ms", "jitter_ms", "loss_pct", "rate_mbit"):
            v = getattr(self, key)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or v != v or v < 0 or v == float("inf"):
                raise WanError(f"{label}: {key} must be a finite number "
                               f">= 0 (got {v!r})")
        if self.loss_pct > 100:
            raise WanError(f"{label}: loss_pct must be <= 100")
        if self.jitter_ms and not self.latency_ms:
            raise WanError(f"{label}: jitter_ms needs latency_ms")

    def is_noop(self) -> bool:
        return not (self.latency_ms or self.loss_pct or self.rate_mbit)

    def to_json(self) -> dict:
        return {k: v for k, v in (
            ("latency_ms", self.latency_ms), ("jitter_ms", self.jitter_ms),
            ("loss_pct", self.loss_pct), ("rate_mbit", self.rate_mbit)) if v}


@dataclass(frozen=True)
class Link:
    src: str
    dst: str
    shape: LinkShape
    name: str = ""

    def label(self) -> str:
        return self.name or f"{self.src}>{self.dst}"

    def to_json(self) -> dict:
        out = {"src": self.src, "dst": self.dst, **self.shape.to_json()}
        if self.name:
            out["name"] = self.name
        return out


@dataclass(frozen=True)
class WanSpec:
    links: tuple = ()
    default: LinkShape | None = None

    def by_name(self, name: str):
        for link in self.links:
            if link.label() == name:
                return link
        return None

    def link_names(self) -> list:
        return [link.label() for link in self.links]

    def to_json(self) -> dict:
        out = {"links": [link.to_json() for link in self.links]}
        if self.default is not None:
            out["default"] = self.default.to_json()
        return out


_SHAPE_KEYS = ("latency_ms", "jitter_ms", "loss_pct", "rate_mbit")


def _shape_from_dict(obj: dict, label: str) -> LinkShape:
    kwargs = {}
    for key in _SHAPE_KEYS:
        if key in obj:
            try:
                kwargs[key] = float(obj[key])
            except (TypeError, ValueError):
                raise WanError(f"{label}: {key} must be a number "
                               f"(got {obj[key]!r})")
    shape = LinkShape(**kwargs)
    shape.validate(label)
    return shape


def _link_from_dict(obj: dict) -> Link:
    unknown = set(obj) - {"src", "dst", "name", *_SHAPE_KEYS}
    if unknown:
        raise WanError(f"unknown link key(s) {sorted(unknown)}")
    try:
        src, dst = str(obj["src"]), str(obj["dst"])
    except KeyError as e:
        raise WanError(f"link needs 'src' and 'dst': missing {e}")
    name = str(obj.get("name", ""))
    label = name or f"{src}>{dst}"
    if not _endpoint_ok(src, allow_wildcard=True):
        raise WanError(f"{label}: bad src {src!r} (want node:<i>, "
                       "sidecar, client, or *)")
    if not _endpoint_ok(dst):
        raise WanError(f"{label}: bad dst {dst!r} (want node:<i>, "
                       "sidecar, or client)")
    if src == dst:
        raise WanError(f"{label}: src and dst must differ")
    return Link(src, dst, _shape_from_dict(obj, label), name)


def _link_from_text(entry: str) -> dict:
    """``"<src>><dst> [k=v ...]"`` / ``"default k=v ..."`` -> link dict
    (the inline DSL; returns dicts so file and DSL share validation)."""
    toks = entry.split()
    if not toks:
        raise WanError("empty WAN entry")
    out = {}
    if toks[0] == "default":
        out["__default__"] = True
    else:
        if ">" not in toks[0]:
            raise WanError(f"bad WAN entry {entry!r}: want "
                           "'<src>><dst> [k=v ...]' or 'default k=v ...'")
        src, _, dst = toks[0].partition(">")
        out["src"], out["dst"] = src, dst
    for tok in toks[1:]:
        if "=" not in tok:
            raise WanError(f"bad param {tok!r} in {entry!r} (want k=v)")
        k, v = tok.split("=", 1)
        out[k] = v
    return out


def parse_wan(spec) -> WanSpec:
    """Parse + validate a WAN spec from any accepted shape:

    * a ``WanSpec`` (returned as-is),
    * a dict: ``{"links": [...], "default": {...}}``,
    * a path to a JSON file of that dict (or a bare link list),
    * an inline DSL string: ``";"``/newline-separated entries like
      ``"node:0>node:1 latency_ms=200 loss_pct=0.5; *>sidecar
      latency_ms=20 name=sc; default latency_ms=50 jitter_ms=5"``.

    Raises :class:`WanError` on anything malformed.
    """
    if isinstance(spec, WanSpec):
        return spec
    if isinstance(spec, str):
        if os.path.isfile(spec):
            try:
                with open(spec, encoding="utf-8") as f:
                    spec = json.load(f)
            except (OSError, ValueError) as e:
                raise WanError(f"cannot read WAN spec {spec!r}: {e}")
        else:
            entries = [e for e in re.split(r"[;\n]", spec) if e.strip()]
            if not entries:
                raise WanError("empty WAN spec")
            parsed = [_link_from_text(e.strip()) for e in entries]
            spec = {"links": [p for p in parsed if "__default__" not in p]}
            defaults = [p for p in parsed if "__default__" in p]
            if len(defaults) > 1:
                raise WanError("more than one 'default' entry")
            if defaults:
                d = dict(defaults[0])
                d.pop("__default__")
                spec["default"] = d
    if isinstance(spec, (list, tuple)):
        spec = {"links": list(spec)}
    if not isinstance(spec, dict):
        raise WanError(f"unsupported WAN spec type {type(spec).__name__}")
    unknown = set(spec) - {"links", "default"}
    if unknown:
        raise WanError(f"unknown WAN spec key(s) {sorted(unknown)}")
    raw_links = spec.get("links", [])
    if not isinstance(raw_links, (list, tuple)):
        raise WanError("'links' must be a list")
    links = []
    for entry in raw_links:
        if not isinstance(entry, dict):
            raise WanError(f"bad link entry {entry!r}")
        links.append(_link_from_dict(entry))
    default = None
    if spec.get("default") is not None:
        if not isinstance(spec["default"], dict):
            raise WanError("'default' must be an object of shape fields")
        bad = set(spec["default"]) - set(_SHAPE_KEYS)
        if bad:
            raise WanError(f"default: unknown shape key(s) {sorted(bad)}")
        default = _shape_from_dict(spec["default"], "default")
    if not links and default is None:
        raise WanError("WAN spec shapes nothing (no links, no default)")
    seen = set()
    for link in links:
        if link.label() in seen:
            raise WanError(f"duplicate link {link.label()!r}")
        seen.add(link.label())
    # Two links covering the same (src-identity, dst) pair are
    # unrealizable: tc would install two same-priority filters for one
    # dst IP (only the first band ever carries traffic, the second
    # link's shape AND its partition/heal plan events silently no-op),
    # and the local WanProxy executor would chain proxies into a
    # topology the spec never declared.  Same dst + same src — or a
    # wildcard src, which expands to every other endpoint — overlaps.
    for i, a in enumerate(links):
        for b in links[i + 1:]:
            if a.dst == b.dst and (a.src == b.src or WILDCARD in
                                   (a.src, b.src)):
                raise WanError(
                    f"links {a.label()!r} and {b.label()!r} both shape "
                    f"traffic into {a.dst!r} from the same source: only "
                    "one would take effect")
    return WanSpec(tuple(links), default)


# ---------------------------------------------------------------------------
# tc/netem compilation (the root-ful remote executor)
# ---------------------------------------------------------------------------


def netem_args(shape: LinkShape) -> str:
    """netem option string for a shape (may be empty: no impairment)."""
    parts = []
    if shape.latency_ms:
        parts.append(f"delay {shape.latency_ms:g}ms")
        if shape.jitter_ms:
            parts.append(f"{shape.jitter_ms:g}ms")
    if shape.loss_pct:
        parts.append(f"loss {shape.loss_pct:g}%")
    if shape.rate_mbit:
        parts.append(f"rate {shape.rate_mbit:g}mbit")
    return " ".join(parts)


def host_links(spec: WanSpec, identity: str, peers: dict) -> list:
    """The directed links THIS host must shape on egress, in a
    deterministic order shared by setup and mid-run partition/heal:
    ``[(link, dst_ip, band)]``.  ``peers`` maps endpoint identities
    (``node:<i>``/``sidecar``) to IPs; the default shape fills every
    peer pair no explicit link covers."""
    out = []
    explicit_dsts = set()
    for link in spec.links:
        if link.src != identity and link.src != WILDCARD:
            continue
        if link.dst == identity or link.dst not in peers:
            continue
        explicit_dsts.add(link.dst)
        out.append((link, peers[link.dst]))
    if spec.default is not None:
        for dst in sorted(peers):
            if dst == identity or dst in explicit_dsts:
                continue
            out.append((Link(identity, dst, spec.default), peers[dst]))
    if _FIRST_BAND - 1 + len(out) > _MAX_BANDS:
        raise WanError(
            f"{identity} carries {len(out)} shaped links but the prio "
            f"qdisc caps at {_MAX_BANDS} bands "
            f"({_MAX_BANDS - _FIRST_BAND + 1} links per host's egress)")
    return [(link, ip, _FIRST_BAND + i)
            for i, (link, ip) in enumerate(out)]


def tc_teardown_command(dev: str = "eth0") -> str:
    return f"sudo tc qdisc del dev {dev} root 2>/dev/null || true"


def tc_setup_commands(spec: WanSpec, identity: str, peers: dict,
                      dev: str = "eth0") -> list:
    """Shell commands installing this host's egress shaping: a prio root
    with one extra band per shaped link, a netem qdisc on each band, and
    a dst-ip u32 filter steering that peer's traffic into it."""
    links = host_links(spec, identity, peers)
    if not links:
        return []
    bands = _FIRST_BAND - 1 + len(links)
    # priomap keeps default traffic in the standard 3 bands; only the
    # u32 filters steer packets into the netem bands.
    cmds = [
        tc_teardown_command(dev),
        f"sudo tc qdisc add dev {dev} root handle 1: prio bands {bands} "
        f"priomap 1 2 2 2 1 2 0 0 1 1 1 1 1 1 1 1",
    ]
    for link, ip, band in links:
        args = netem_args(link.shape)
        # tc parses classid minors and handle majors as HEX: band 10
        # written "1:10" would mean minor 0x10 = 16, a class the prio
        # root never created.  Format every band reference in hex.
        cmds.append(
            f"sudo tc qdisc add dev {dev} parent 1:{band:x} "
            f"handle {band:x}0: netem {args}".rstrip())
        cmds.append(
            f"sudo tc filter add dev {dev} protocol ip parent 1:0 prio 1 "
            f"u32 match ip dst {ip}/32 flowid 1:{band:x}")
    return cmds


def _tc_change(link, band, dev, args: str) -> str:
    cmd = (f"sudo tc qdisc change dev {dev} parent 1:{band:x} "
           f"handle {band:x}0: netem {args}")
    return cmd.rstrip()


def tc_partition_commands(spec: WanSpec, link_name: str, identity: str,
                          peers: dict, dev: str = "eth0") -> list:
    """Mid-run ``link:<name> partition``: 100% loss on the link's band
    for hosts whose egress carries it (empty list for the rest)."""
    return [_tc_change(link, band, dev, "loss 100%")
            for link, _ip, band in host_links(spec, identity, peers)
            if link.label() == link_name]


def tc_heal_commands(spec: WanSpec, link_name: str, identity: str,
                     peers: dict, dev: str = "eth0") -> list:
    """Mid-run ``link:<name> heal``: restore the spec's shape."""
    return [_tc_change(link, band, dev, netem_args(link.shape) or "delay 0ms")
            for link, _ip, band in host_links(spec, identity, peers)
            if link.label() == link_name]


# ---------------------------------------------------------------------------
# WanProxy (the root-free local/CI executor)
# ---------------------------------------------------------------------------

_CHUNK = 65536
_POLL_S = 0.25


class _TokenBucket:
    """Byte-rate limiter for one pump direction of a WanProxy link.

    The old model charged every chunk ``len * 8 / rate`` of sleep
    regardless of how much wall clock had already passed between chunks
    — a sender with natural gaps was double-charged (its idle time
    earned no credit), which made shaped caps increasingly inaccurate
    as the cap dropped (ROADMAP item-5 follow-up: coarse below
    ~1 Mbit).  A token bucket fixes both ends: tokens accrue with
    elapsed time at the link rate (idle time earns credit up to
    ``burst``), each chunk spends its byte count, and only a deficit
    sleeps — so the long-run rate equals the cap for any send pattern.

    ``delay(n)`` returns the seconds the pump must sleep BEFORE
    forwarding the chunk; tokens may go negative (the debt is the sleep
    being returned), and the next refill credits that slept time back.
    Thread-safe: every connection of the direction shares one bucket —
    the link's rate is a property of the link, not of a socket pair.
    The clock is injectable for deterministic tests."""

    def __init__(self, rate_mbit: float, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = 0.0
        self._last = None
        self.set_rate(rate_mbit)

    def set_rate(self, rate_mbit: float):
        with self._lock:
            self._rate = rate_mbit * 1e6 / 8.0  # bytes per second
            # Burst: enough for a short scheduling hiccup, never so much
            # that a low cap stops binding (50 ms of line rate, floored
            # at 8 KiB so tiny caps still make progress chunk by chunk).
            self._burst = max(self._rate * 0.05, 8192.0)
            self._tokens = min(self._tokens, self._burst)

    def delay(self, nbytes: int) -> float:
        """Seconds to sleep before forwarding an nbytes chunk."""
        with self._lock:
            if self._rate <= 0:
                return 0.0
            now = self._clock()
            if self._last is not None:
                self._tokens = min(self._burst,
                                   self._tokens + (now - self._last)
                                   * self._rate)
            else:
                self._tokens = self._burst  # first chunk rides the burst
            self._last = now
            self._tokens -= nbytes
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self._rate


class WanProxy:
    """Userspace delay/loss/rate TCP proxy for ONE directed link.

    Listens on ``127.0.0.1:<listen_port>`` (0 = ephemeral) and forwards
    to ``target``; each forwarded chunk pays the link's latency (+-
    jitter), the rate cap, and the loss lottery (a lost chunk drops the
    whole connection — see the module docstring for why).  The shape
    applies to BOTH pump directions: a TCP conversation over a shaped
    link pays the delay each way, like netem on both hosts' egress.

    ``partition()`` makes the link black-hole (live connections die, new
    ones are accepted and immediately dropped — exactly what a routing
    partition looks like to a dialing peer); ``heal()`` restores the
    spec shape.  ``rng`` is injectable so loss is deterministic in
    tests.

    Rate caps are enforced by a per-direction shared token bucket
    (``_TokenBucket``): elapsed time earns byte credit at the link
    rate, each forwarded chunk spends its size, and only a deficit
    sleeps — accurate at ANY cap (the old per-chunk charge ignored
    inter-chunk idle time, so caps under ~1 Mbit over-shaped).

    ``start()`` returns before the proxy accepts connections: the accept
    loop first waits for the upstream target to answer a dial (so a peer
    probing a shaped front sees the NODE's readiness, not the proxy's).
    Callers that know the target is already up — tests, the bench probe
    — use ``wait_ready()`` to block until the listener is live.
    """

    def __init__(self, target, shape: LinkShape | None = None,
                 listen_port: int = 0, rng=None,
                 connect_timeout: float = 5.0):
        self.target = target
        self.shape = shape or LinkShape()
        self.shape.validate("WanProxy")
        self._listen_port = listen_port
        self._rng = rng or random.Random()
        self._connect_timeout = connect_timeout
        self._partitioned = False
        self._ready = threading.Event()
        self._stopping = threading.Event()
        self._lock = threading.Lock()
        self._listener = None
        self._threads = []
        self._conns = []
        self.port = None
        # One bucket per pump direction, shared across connections: the
        # cap is the LINK's rate each way, like netem on a host's egress.
        self._bucket_fwd = _TokenBucket(self.shape.rate_mbit)
        self._bucket_rev = _TokenBucket(self.shape.rate_mbit)

    # -- control ------------------------------------------------------------

    def start(self) -> int:
        assert self._listener is None, "proxy already started"
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("127.0.0.1", self._listen_port))
        # listen() happens in the accept thread AFTER the upstream
        # answers a dial: until then a connect to the proxy is REFUSED,
        # so a client probing a shaped front sees the NODE's readiness,
        # not the proxy's (otherwise the proxy would defeat the boot
        # wait loop that retries fronts until reachable).
        listener.settimeout(_POLL_S)
        self._listener = listener
        self.port = listener.getsockname()[1]
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"wanproxy-{self.port}")
        t.start()
        self._threads.append(t)
        return self.port

    def wait_ready(self, timeout: float = 10.0) -> bool:
        """Block until the readiness gate has passed and the listener
        accepts connections (i.e. the upstream target answered a dial).
        Returns False on timeout or if the proxy was stopped first."""
        return self._ready.wait(timeout) and not self._stopping.is_set()

    def stop(self):
        self._stopping.set()
        self._ready.set()  # wake wait_ready() callers (they return False)
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self._drop_all()
        for t in self._threads:
            t.join(timeout=5.0)

    def set_shape(self, shape: LinkShape):
        shape.validate("WanProxy")
        with self._lock:
            self.shape = shape
        self._bucket_fwd.set_rate(shape.rate_mbit)
        self._bucket_rev.set_rate(shape.rate_mbit)

    def partition(self):
        """Black-hole the link: kill live connections, drop new ones."""
        with self._lock:
            self._partitioned = True
        self._drop_all()

    def heal(self):
        with self._lock:
            self._partitioned = False

    def partitioned(self) -> bool:
        with self._lock:
            return self._partitioned

    # -- internals ----------------------------------------------------------

    def _drop_all(self):
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def _accept_loop(self):
        listener = self._listener
        # Readiness gate: refuse connects until the upstream dials.
        while not self._stopping.is_set():
            try:
                socket.create_connection(self.target,
                                         timeout=_POLL_S).close()
                break
            except OSError:
                time.sleep(_POLL_S)
        if self._stopping.is_set():
            return
        try:
            listener.listen(64)
        except OSError:
            return  # stopped between the gate and the listen
        self._ready.set()
        while not self._stopping.is_set():
            try:
                conn, _addr = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            if self.partitioned():
                # The dialer sees an immediate RST/EOF — a black-holed
                # route, not a listening service.
                conn.close()
                continue
            try:
                upstream = socket.create_connection(
                    self.target, timeout=self._connect_timeout)
            except OSError:
                conn.close()
                continue
            conn.settimeout(_POLL_S)
            upstream.settimeout(_POLL_S)
            with self._lock:
                self._conns += [conn, upstream]
                # Prune finished pump threads: a lossy or partitioned
                # link churns connections, and an append-only list
                # would retain every dead thread until stop().
                self._threads = [t for t in self._threads
                                 if t.is_alive()]
            for a, b, bucket in ((conn, upstream, self._bucket_fwd),
                                 (upstream, conn, self._bucket_rev)):
                t = threading.Thread(target=self._pump, args=(a, b, bucket),
                                     daemon=True)
                t.start()
                with self._lock:
                    self._threads.append(t)

    def _pump(self, src_conn, dst_conn, bucket: "_TokenBucket"):
        try:
            # Both ends were bounded at accept time; re-assert here so
            # the bound is visible in the scope doing the recv (the
            # graftlint unbounded-socket-op rule is lexical, and so are
            # reviewers).  Guarded: partition()/stop() may close the
            # socket before this thread's first statement runs.
            try:
                src_conn.settimeout(_POLL_S)
            except OSError:
                return
            while not self._stopping.is_set():
                if self.partitioned():
                    break
                try:
                    data = src_conn.recv(_CHUNK)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                with self._lock:
                    shape = self.shape
                if shape.loss_pct and \
                        self._rng.random() * 100.0 < shape.loss_pct:
                    break  # lost chunk = dropped connection (see above)
                delay = 0.0
                if shape.latency_ms:
                    jitter = (self._rng.uniform(-shape.jitter_ms,
                                                shape.jitter_ms)
                              if shape.jitter_ms else 0.0)
                    delay += max(0.0, shape.latency_ms + jitter) / 1e3
                if shape.rate_mbit:
                    # Token bucket, not per-chunk charging: idle time
                    # between chunks earns credit, so the cap is what
                    # the spec says at any rate (see _TokenBucket).
                    delay += bucket.delay(len(data))
                if delay:
                    time.sleep(delay)
                try:
                    dst_conn.sendall(data)
                except OSError:
                    break
        finally:
            for s in (src_conn, dst_conn):
                try:
                    s.close()
                except OSError:
                    pass
