"""``python -m hotstuff_tpu_torch.harness local --sidecar-host-crypto``
end to end: the port's harness boots a 4-node committee of the unchanged
C++ node, its clients and the port's sidecar on the host, runs the
window, and mines the logs; for both signature schemes.

Skipped where the native binaries are not built (scripts/native_build.sh
builds them without cmake; the harness's compile step rebuilds them with
cmake where cmake and ninja exist).  Each run takes one to two minutes.
"""

import os
import re
import shutil
import signal
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE_BIN = os.path.join(REPO, "native", "build", "node")
CLIENT_BIN = os.path.join(REPO, "native", "build", "client")

pytestmark = pytest.mark.skipif(
    not (os.path.exists(NODE_BIN) and os.path.exists(CLIENT_BIN)),
    reason="native binaries not built (scripts/native_build.sh)")


def _number(summary: str, label: str) -> float:
    m = re.search(rf" {label}: ([\d,]+) ", summary)
    assert m, f"no {label!r} in the summary"
    return float(m.group(1).replace(",", ""))


# A host BLS check is 0.1-2 s of Python bigints, past the harness's
# 1,000 ms view timeout: at the defaults neither package's harness
# commits a block under --scheme bls --sidecar-host-crypto.  The BLS run
# gets a 5,000 ms timeout and a 30 s window, and 1,000 tx/s, since at
# the default 100,000 tx/s the replicas' mempools outgrow the slow
# commits by gigabytes.
RUNS = {"ed25519": ["--duration", "10"],
        "bls": ["--scheme", "bls", "--timeout", "5000", "--duration", "30",
                "--rate", "1000"]}


def _kill_under(path):
    """SIGKILL every process whose working directory is under ``path``:
    the harness's nodes, clients and sidecar outlive a harness killed by
    the timeout (each runs in a session of its own)."""
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            if os.readlink(f"/proc/{pid}/cwd").startswith(str(path)):
                os.kill(int(pid), signal.SIGKILL)
        except OSError:
            pass


@pytest.mark.parametrize("scheme", sorted(RUNS))
def test_local_bench_through_the_port_sidecar_on_the_host(tmp_path, scheme):
    os.symlink(os.path.join(REPO, "native"), tmp_path / "native")
    argv = [sys.executable, "-m", "hotstuff_tpu_torch.harness", "local",
            "--sidecar-host-crypto", *RUNS[scheme]]
    env = {**os.environ,
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    try:
        proc = subprocess.run(argv, cwd=tmp_path, env=env,
                              capture_output=True, text=True, timeout=600)
    finally:
        _kill_under(tmp_path)
        for store in tmp_path.glob(".db-*"):
            shutil.rmtree(store, ignore_errors=True)
    sidecar_log = (tmp_path / "logs" / "sidecar.log").read_text()
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    summary = proc.stdout
    for label in ("Consensus TPS", "Consensus latency", "End-to-end TPS",
                  "End-to-end latency"):
        assert _number(summary, label) > 0, label
    assert "Sidecar launches:" in summary
    if scheme == "ed25519":
        assert "Sidecar verify paths: host=" in summary
    else:
        assert re.search(r"Sidecar verify paths: .*bls_", summary)
    assert "listening on 127.0.0.1:7100 (host crypto)" in sidecar_log
    assert "Traceback" not in sidecar_log
    assert (tmp_path / "logs" / "sidecar-stats.json").exists()
    assert (tmp_path / "logs" / "trace.json").exists()
