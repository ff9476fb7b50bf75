"""Benchmark configuration: committee/parameters JSON writers matching the
C++ node's readers (native/src/node/config.cpp), plus bench/plot parameter
validation. Mirrors benchmark/benchmark/config.py:8-173 in the reference —
the committee schema is wire-compatible with the node so harness and node
evolve together.
"""

from __future__ import annotations

import json
from collections import OrderedDict


class ConfigError(Exception):
    pass


class Key:
    def __init__(self, name, secret):
        self.name = name
        self.secret = secret

    @classmethod
    def from_file(cls, filename):
        assert isinstance(filename, str)
        with open(filename, "r") as f:
            data = json.load(f)
        return cls(data["name"], data["secret"])


class Committee:
    """Address book for consensus + mempool, one authority per node.

    consensus: one address (peer consensus messages)
    mempool: transactions_address (:front, clients) + mempool_address (peers)
    """

    def __init__(self, names, consensus_addr, front_addr, mempool_addr,
                 bls_pubkeys=None):
        inputs = [names, consensus_addr, front_addr, mempool_addr]
        assert all(isinstance(x, list) for x in inputs)
        assert all(isinstance(x, str) for y in inputs for x in y)
        assert len({len(x) for x in inputs}) == 1
        assert bls_pubkeys is None or len(bls_pubkeys) == len(names)

        self.names = names
        self.consensus = consensus_addr
        self.front = front_addr
        self.mempool = mempool_addr
        self.bls_pubkeys = bls_pubkeys  # base64 96-byte G1, scheme=bls only

        self.json = {
            "consensus": self._build_consensus(),
            "mempool": self._build_mempool(),
        }

    def _build_consensus(self):
        node = {}
        for i, (name, address) in enumerate(zip(self.names, self.consensus)):
            entry = {"stake": 1, "address": address}
            if self.bls_pubkeys:
                entry["bls_pubkey"] = self.bls_pubkeys[i]
            node[name] = entry
        return {"authorities": node, "epoch": 1}

    def _build_mempool(self):
        node = {}
        for name, front, mempool in zip(self.names, self.front, self.mempool):
            node[name] = {
                "stake": 1,
                "transactions_address": front,
                "mempool_address": mempool,
            }
        return {"authorities": node, "epoch": 1}

    def print(self, filename):
        assert isinstance(filename, str)
        with open(filename, "w") as f:
            json.dump(self.json, f, indent=4, sort_keys=True)

    def size(self):
        return len(self.names)

    def front_addresses(self):
        return self.front

    @staticmethod
    def ip(address):
        assert isinstance(address, str)
        return address.split(":")[0]


class LocalCommittee(Committee):
    """All nodes on localhost, 3 consecutive ports per node from a base
    (benchmark/benchmark/config.py:81-90 convention)."""

    def __init__(self, names, port, bls_pubkeys=None):
        assert isinstance(names, list)
        assert isinstance(port, int)
        size = len(names)
        consensus = [f"127.0.0.1:{port + i}" for i in range(size)]
        front = [f"127.0.0.1:{port + i + size}" for i in range(size)]
        mempool = [f"127.0.0.1:{port + i + 2 * size}" for i in range(size)]
        super().__init__(names, consensus, front, mempool,
                         bls_pubkeys=bls_pubkeys)


def twin_committee(committee, index, port):
    """Committee view for a Twins-style equivocating replica (Bano et
    al.): the SAME identity as replica ``index`` — same keypair, same
    authority entry for every peer — but with its OWN entry's addresses
    remapped to three consecutive ports from ``port``, so the twin
    process binds fresh sockets while signing as its sibling.

    The harness boots the twin with this view and splits the honest
    committee across the two views (half dial the original's ports,
    half the twin's), so BOTH replicas sharing the key receive votes
    and either can propose in the shared identity's leader slots —
    scripted equivocation, which safety must contain (the LogParser's
    conflicting-commit assertion), not merely survive.
    """
    import copy

    assert 0 <= index < len(committee.names)
    name = committee.names[index]
    data = copy.deepcopy(committee.json)
    data["consensus"]["authorities"][name]["address"] = \
        f"127.0.0.1:{port}"
    entry = data["mempool"]["authorities"][name]
    entry["transactions_address"] = f"127.0.0.1:{port + 1}"
    entry["mempool_address"] = f"127.0.0.1:{port + 2}"
    return data


def write_committee_json(data, filename):
    """Write a committee JSON view (twin_committee output) in the same
    format Committee.print uses, so the C++ reader sees no difference."""
    assert isinstance(filename, str)
    with open(filename, "w") as f:
        json.dump(data, f, indent=4, sort_keys=True)


class NodeParameters:
    def __init__(self, json_input):
        inputs = []
        try:
            inputs += [json_input["consensus"]["timeout_delay"]]
            inputs += [json_input["consensus"]["sync_retry_delay"]]
            inputs += [json_input["mempool"]["gc_depth"]]
            inputs += [json_input["mempool"]["sync_retry_delay"]]
            inputs += [json_input["mempool"]["sync_retry_nodes"]]
            inputs += [json_input["mempool"]["batch_size"]]
            inputs += [json_input["mempool"]["max_batch_delay"]]
        except KeyError as e:
            raise ConfigError(f"Malformed parameters: missing key {e}")
        # graftview pacemaker knobs: optional, but when present they must
        # be ints the C++ reader accepts (its own range checks mirror
        # these — a typo'd value must fail at harness time, not as a
        # node-boot crash mid-bench).
        cons = json_input["consensus"]
        for key, lo, hi in (("timeout_backoff_factor_pct", 100, None),
                            ("timeout_backoff_cap", 1, None),
                            ("timeout_jitter_pct", 0, 100),
                            ("timeout_future_horizon", 1, None)):
            v = cons.get(key)
            if v is None:
                continue
            if not isinstance(v, int) or isinstance(v, bool) or v < lo \
                    or (hi is not None and v > hi):
                raise ConfigError(
                    f"{key} must be an int >= {lo}"
                    + (f" and <= {hi}" if hi is not None else "")
                    + f" (got {v!r})")
            inputs += [v]
        if not all(isinstance(x, int) for x in inputs):
            raise ConfigError("Invalid parameters type")
        # graftfleet: tpu_sidecar is one address string (legacy) or an
        # ordered list of them (first = primary, the failover ladder).
        sidecar = json_input.get("tpu_sidecar")
        if sidecar is not None and not isinstance(sidecar, str) and not (
                isinstance(sidecar, list) and sidecar
                and all(isinstance(a, str) for a in sidecar)):
            raise ConfigError("tpu_sidecar must be an address string or a "
                              "non-empty list of address strings")
        tenant = json_input.get("tpu_tenant")
        if tenant is not None and not isinstance(tenant, str):
            raise ConfigError("tpu_tenant must be a string")
        trace = json_input.get("trace")
        if trace is not None and not isinstance(trace, bool):
            raise ConfigError("trace must be a bool")
        # graftdag generalizes the commit walk to any k-chain in [2, 8]
        # (the C++ reader enforces the same range).
        chain = json_input["consensus"].get("chain_depth", 2)
        if not isinstance(chain, int) or isinstance(chain, bool) \
                or not 2 <= chain <= 8:
            raise ConfigError("chain_depth must be an int in [2, 8]")
        # graftdag certified-batch mode: ONE harness knob that must land
        # on BOTH sides of the node (the consensus proposer carries certs
        # and skips the broadcast-ACK wait; the mempool signs availability
        # ACKs and assembles certificates) — a half-set knob would wedge
        # every proposal, so the harness writes/checks them in lockstep.
        dag_c = json_input["consensus"].get("dag", False)
        dag_m = json_input["mempool"].get("dag", False)
        if not isinstance(dag_c, bool) or not isinstance(dag_m, bool):
            raise ConfigError("dag must be a bool")
        if dag_c != dag_m:
            raise ConfigError(
                "dag must be set on both consensus and mempool (lockstep)")
        self.timeout_delay = json_input["consensus"]["timeout_delay"]
        self.json = json_input

    def print(self, filename):
        assert isinstance(filename, str)
        with open(filename, "w") as f:
            json.dump(self.json, f, indent=4, sort_keys=True)

    @classmethod
    def default(cls, tpu_sidecar=None, scheme=None, chain=2, tenant=None,
                dag=False):
        # grafttrace's node-side "trace" flag is not a kwarg here: the
        # harnesses enable it via json.setdefault("trace", True) on
        # whatever parameters the caller built (local.py / remote.py).
        data = {
            "consensus": {"timeout_delay": 5_000, "sync_retry_delay": 10_000},
            "mempool": {
                "gc_depth": 50,
                "sync_retry_delay": 5_000,
                "sync_retry_nodes": 3,
                "batch_size": 500_000,
                "max_batch_delay": 100,
            },
        }
        if chain != 2:
            data["consensus"]["chain_depth"] = chain
        if dag:
            data["consensus"]["dag"] = True
            data["mempool"]["dag"] = True
        if tpu_sidecar:
            data["tpu_sidecar"] = tpu_sidecar
        if tenant:
            data["tpu_tenant"] = tenant
        if scheme:
            data["scheme"] = scheme
        return cls(data)


def add_bls_keys(key_files, committee_names):
    """Generate a BLS keypair per node (scheme=bls deployments): injects
    base64 'bls_secret' into each key file and returns the base64
    96-byte G1 public keys in committee order."""
    import base64

    from ..offchain import bls12381 as bls

    pubkeys = {}
    for filename in key_files:
        with open(filename, "r") as f:
            data = json.load(f)
        # Fresh cryptographic randomness per node — NOT derived from the
        # public name (that would let anyone recompute every secret from
        # the committee file).
        sk, pk = bls.key_gen()
        data["bls_secret"] = base64.b64encode(
            sk.to_bytes(48, "big")).decode()
        with open(filename, "w") as f:
            json.dump(data, f, indent=4, sort_keys=True)
        pubkeys[data["name"]] = base64.b64encode(
            bls.g1_encode(pk)).decode()
    return [pubkeys[name] for name in committee_names]


class BenchParameters:
    def __init__(self, json_input):
        try:
            nodes = json_input["nodes"]
            nodes = nodes if isinstance(nodes, list) else [nodes]
            if not nodes or any(x <= 1 for x in nodes):
                raise ConfigError("Missing or invalid number of nodes")
            rate = json_input["rate"]
            rate = rate if isinstance(rate, list) else [rate]
            if not rate:
                raise ConfigError("Missing input rate")
            self.nodes = [int(x) for x in nodes]
            self.rate = [int(x) for x in rate]
            self.tx_size = int(json_input["tx_size"])
            self.faults = int(json_input["faults"])
            self.duration = int(json_input["duration"])
            self.runs = int(json_input.get("runs", 1))
            self.tpu_sidecar = bool(json_input.get("tpu_sidecar", False))
            self.sidecar_host_crypto = bool(
                json_input.get("sidecar_host_crypto", False))
            self.sidecar_warm_rlc = bool(
                json_input.get("sidecar_warm_rlc", False))
            self.sidecar_mesh = int(json_input.get("sidecar_mesh", 0))
            # graftfleet: boot k sidecars and hand every node the ordered
            # endpoint list (0 or 1 = the single legacy sidecar).
            self.sidecar_fleet = int(json_input.get("sidecar_fleet", 0))
            self.scheme = str(json_input.get("scheme", "ed25519"))
            # graftchaos: a fault-plan spec (path / inline DSL string /
            # event list); parsed + validated by LocalBench.
            self.fault_plan = json_input.get("fault_plan")
            # graftwan: a WAN link-shape spec and a recovery-SLO table
            # (each a path / inline DSL / dict), and the Twins toggle
            # (boot an equivocating sibling of replica 0); parsed +
            # validated by the bench.
            self.wan = json_input.get("wan")
            self.slo = json_input.get("slo")
            self.twins = bool(json_input.get("twins", False))
            # graftingress: signed-transaction ingress.  verify_ingress
            # flips the nodes into admission-verify mode AND the clients
            # into --sign; forge_pct seeds a forgery mix the admission
            # stage must reject; client_shards fans each node's client
            # out over k processes (disjoint user-id / sample-id spaces).
            self.verify_ingress = bool(
                json_input.get("verify_ingress", False))
            self.forge_pct = float(json_input.get("forge_pct", 0.0))
            self.client_shards = int(json_input.get("client_shards", 1))
        except KeyError as e:
            raise ConfigError(f"Malformed bench parameters: missing key {e}")
        except ValueError:
            raise ConfigError("Invalid parameters type")
        if min(self.nodes) <= self.faults:
            raise ConfigError("There should be more nodes than faults")
        if self.client_shards < 1:
            raise ConfigError("client_shards must be >= 1")
        if self.sidecar_fleet < 0:
            raise ConfigError("sidecar_fleet must be >= 0")
        if self.sidecar_fleet > 1 and not (
                self.tpu_sidecar or self.sidecar_host_crypto
                or self.scheme == "bls"):
            # A fleet of sidecars nobody dials is a silent misconfig.
            # host-crypto and bls runs boot a sidecar too, so they may
            # fleet it (LocalBench flips tpu_sidecar on for both).
            raise ConfigError("sidecar_fleet requires tpu_sidecar (or "
                              "sidecar_host_crypto / scheme=bls)")
        if not 0.0 <= self.forge_pct <= 100.0:
            raise ConfigError("forge_pct must be within [0, 100]")
        if self.forge_pct and not self.verify_ingress:
            # Without admission verify, forged txs would commit and
            # silently poison the run's numbers.
            raise ConfigError("forge_pct requires verify_ingress")


class PlotParameters:
    def __init__(self, json_input):
        try:
            faults = json_input["faults"]
            faults = faults if isinstance(faults, list) else [faults]
            self.faults = [int(x) for x in faults] if faults else [0]
            nodes = json_input["nodes"]
            nodes = nodes if isinstance(nodes, list) else [nodes]
            if not nodes:
                raise ConfigError("Missing number of nodes")
            self.nodes = [int(x) for x in nodes]
            self.tx_size = int(json_input["tx_size"])
            max_lat = json_input["max_latency"]
            max_lat = max_lat if isinstance(max_lat, list) else [max_lat]
            if not max_lat:
                raise ConfigError("Missing max latency")
            self.max_latency = [int(x) for x in max_lat]
        except KeyError as e:
            raise ConfigError(f"Malformed plot parameters: missing key {e}")
        except ValueError:
            raise ConfigError("Invalid parameters type")


def ordered(data):
    return OrderedDict(sorted(data.items()))
