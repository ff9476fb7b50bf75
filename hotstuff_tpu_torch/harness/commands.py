"""Shell command strings for the benchmark harness
(benchmark/benchmark/commands.py:6-56 capability: compile, keygen, run
node/client, cleanup, binary aliases) — targeting the C++ CMake build
instead of cargo.
"""

from __future__ import annotations

from os.path import join

from .utils import PathMaker


class CommandMaker:
    @staticmethod
    def cleanup():
        return (
            f"rm -rf .db-* ; rm -f .*.json ; "
            f"mkdir -p {PathMaker.results_path()}"
        )

    @staticmethod
    def clean_logs():
        return f"rm -rf {PathMaker.logs_path()} ; mkdir -p {PathMaker.logs_path()}"

    @staticmethod
    def compile():
        # A build dir configured with a different generator (or a stale
        # toolchain path) makes `cmake -G Ninja` fail on its cache; wipe the
        # cache and reconfigure instead of aborting the whole benchmark.
        src, bld = PathMaker.node_crate_path(), PathMaker.binary_path()
        cfg = f"cmake -S {src} -B {bld} -G Ninja"
        # No cmake in the environment (e.g. the CI container builds the
        # binaries with scripts/native_sanitize.sh-style direct g++): accept
        # prebuilt node+client in the build dir instead of aborting the run.
        return (
            f"if command -v cmake >/dev/null 2>&1 ; then "
            f"( {cfg} || {{ rm -rf {bld}/CMakeCache.txt {bld}/CMakeFiles "
            f"&& {cfg} ; }} ) && cmake --build {bld} ; "
            f"else test -x {bld}/node && test -x {bld}/client ; fi"
        )

    @staticmethod
    def generate_key(filename):
        assert isinstance(filename, str)
        return f"./node keys --filename {filename}"

    @staticmethod
    def run_node(keys, committee, store, parameters, debug=False):
        assert isinstance(keys, str)
        assert isinstance(committee, str)
        assert isinstance(parameters, str)
        assert isinstance(debug, bool)
        v = "-vv" if debug else "-v"
        return (
            f"./node run --keys {keys} --committee {committee} "
            f"--store {store} --parameters {parameters} {v}"
        )

    @staticmethod
    def run_client(address, size, rate, timeout, nodes=None, users=None,
                   seed=None, sign=False, forge_pct=None, user_offset=None,
                   sample_offset=None):
        """``users``/``seed`` opt into the graftsurge multi-user
        heavy-tailed generator (client --users/--seed); omitted, the
        client keeps its legacy constant-rate stream.  ``sign`` opts
        into graftingress signed-transaction frames (per-user Ed25519,
        derived from the seed); ``forge_pct`` flips a signature bit on
        that percentage of filler txs; the offsets shard the user-id
        and sample-id spaces across multi-process client shards."""
        assert isinstance(address, str)
        assert isinstance(size, int) and size > 0
        assert isinstance(rate, int) and rate >= 0
        assert isinstance(nodes, list) or nodes is None
        assert users is None or (isinstance(users, int) and users > 0)
        assert seed is None or isinstance(seed, int)
        assert forge_pct is None or \
            (isinstance(forge_pct, (int, float)) and 0 <= forge_pct <= 100)
        assert user_offset is None or \
            (isinstance(user_offset, int) and user_offset >= 0)
        assert sample_offset is None or \
            (isinstance(sample_offset, int) and sample_offset >= 0)
        nodes = nodes or []
        assert all(isinstance(x, str) for x in nodes)
        nodes_str = f" --nodes {' '.join(nodes)}" if nodes else ""
        users_str = f" --users {users}" if users else ""
        seed_str = f" --seed {seed}" if seed is not None else ""
        sign_str = " --sign" if sign else ""
        forge_str = f" --forge-pct {forge_pct:g}" if forge_pct else ""
        uoff_str = f" --user-offset {user_offset}" \
            if user_offset else ""
        soff_str = f" --sample-offset {sample_offset}" \
            if sample_offset else ""
        return (
            f"./client {address} --size {size} "
            f"--rate {rate} --timeout {timeout}{users_str}{seed_str}"
            f"{sign_str}{forge_str}{uoff_str}{soff_str}"
            f"{nodes_str}"
        )

    @staticmethod
    def run_sidecar(port, log_path):
        return (
            f"python -m hotstuff_tpu_torch.sidecar --port {port} "
            f"> {log_path} 2>&1"
        )

    @staticmethod
    def kill():
        return "tmux kill-server 2>/dev/null || true"

    @staticmethod
    def alias_binaries(origin):
        assert isinstance(origin, str)
        node, client = join(origin, "node"), join(origin, "client")
        return f"rm -f node client ; ln -s {node} . ; ln -s {client} ."
