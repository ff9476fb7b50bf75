"""Node-quartet <-> the port's sidecar: the flagship scenario of
tests/test_integration.py with ``python -m hotstuff_tpu_torch.sidecar
--host-crypto`` in place of the JAX package's sidecar.

Asserts (a) a 4-node committee of the unchanged C++ node routes QC
verification through the port's sidecar and commits blocks, with and
without a tenant (the node then opens each connection with OP_HELLO, as
a fleet member of hotstuff_tpu/harness/local.py does), and (b) killing
the sidecar mid-run degrades to host verification instead of stalling
consensus.  The sidecar runs --host-crypto, so no card is
involved; skipped where the native binaries are not built
(scripts/native_build.sh).
"""

import json
import os
import sys

import pytest

from conftest import (
    CLIENT_BIN, NODE_BIN, count_in_log, free_port, make_committee,
    wait_commits, wait_sidecar_ping,
)

pytestmark = pytest.mark.skipif(
    not (os.path.exists(NODE_BIN) and os.path.exists(CLIENT_BIN)),
    reason="native binaries not built (cmake --build native/build)")

NODES = 4
TIMEOUT_DELAY_MS = 1000


@pytest.mark.parametrize("tenant", [None, "node"])
def test_port_sidecar_backed_consensus_and_failover(testbed, tenant):
    tmp_path, spawn = testbed
    sidecar_port = free_port()
    _, committee, _ = make_committee(tmp_path, NODES, TIMEOUT_DELAY_MS,
                                     sidecar_port=sidecar_port)
    if tenant:
        params = tmp_path / ".parameters.json"
        data = json.loads(params.read_text())
        data["tpu_tenant"] = tenant
        params.write_text(json.dumps(data))

    sidecar = spawn(
        [sys.executable, "-m", "hotstuff_tpu_torch.sidecar", "--port",
         str(sidecar_port), "--host-crypto"],
        "sidecar.log")
    assert wait_sidecar_ping(sidecar_port, deadline_s=60), \
        "the port's sidecar never became ready"

    node_logs = []
    for i in range(NODES):
        spawn([NODE_BIN, "run", "--keys", f".node-{i}.json",
               "--committee", ".committee.json", "--store", f".db-{i}",
               "--parameters", ".parameters.json", "-v"],
              f"node-{i}.log")
        node_logs.append(tmp_path / f"node-{i}.log")
    for i, addr in enumerate(committee.front_addresses()):
        spawn([CLIENT_BIN, addr, "--size", "64", "--rate", "250",
               "--timeout", str(TIMEOUT_DELAY_MS),
               "--nodes", *committee.front_addresses()],
              f"client-{i}.log")

    # -- phase 1: commits flow through the port's sidecar -----------------
    counts = wait_commits(node_logs, minimum=3, deadline_s=60)
    assert all(c >= 3 for c in counts), f"no commits with sidecar: {counts}"
    assert all(count_in_log(p, "connected to verify sidecar") >= 1
               for p in node_logs), "a node never used the sidecar"
    assert count_in_log(tmp_path / "sidecar.log", "Traceback") == 0
    if tenant:
        assert all(count_in_log(p, "HELLO accepted") >= 1
                   for p in node_logs), "a node's HELLO was not accepted"

    # -- phase 2: kill the sidecar; consensus must keep committing --------
    sidecar.kill()
    sidecar.wait()
    before = [count_in_log(p, "Committed B") for p in node_logs]
    after = wait_commits(node_logs, minimum=max(before) + 3, deadline_s=30)
    assert all(a > b for a, b in zip(after, before)), (
        f"consensus stalled after sidecar death: {before} -> {after}")
