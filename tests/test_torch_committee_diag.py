"""chip_smoke.py's committee diagnostics on a made-up replica log: slow
consensus events are filed by the name of their CoreEvent::Kind
(native/src/consensus/core.hpp), and by the message's kind only for a
kMessage, since the node prints a message kind for every event."""

from __future__ import annotations

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


NODE_LOG = """\
[2026-10-18T10:00:00.000Z INFO consensus::core] Created B7
[2026-10-18T10:00:01.000Z WARN consensus::core] SLOW event kind=2 msg_kind=0 took 1678 ms
[2026-10-18T10:00:02.000Z WARN consensus::core] SLOW event kind=2 msg_kind=3 took 5276 ms
[2026-10-18T10:00:03.000Z WARN consensus::core] SLOW event kind=1 msg_kind=0 took 589 ms
[2026-10-18T10:00:04.000Z WARN consensus::core] SLOW event kind=0 msg_kind=1 took 612 ms
[2026-10-18T10:00:05.000Z WARN consensus::core] SLOW event kind=0 msg_kind=0 took 701 ms
[2026-10-18T10:00:06.000Z WARN consensus::core] SLOW event kind=3 msg_kind=2 took 530 ms
[2026-10-18T10:00:07.000Z WARN consensus::core] SLOW event kind=0 msg_kind=9 took 520 ms
[2026-10-18T10:00:08.000Z WARN consensus::core] Timeout reached for round 9
"""


def test_slow_events_are_labelled_by_event_kind(smoke):
    diag = smoke.committee_diagnostics({"node-0": NODE_LOG}, {})
    node = diag["nodes"]["node-0"]
    assert node["slow_events"] == {
        "kVerdict": {"n": 2, "max_ms": 5276},
        "kLoopback": {"n": 1, "max_ms": 589},
        "kMessage kVote": {"n": 1, "max_ms": 612},
        "kMessage kPropose": {"n": 1, "max_ms": 701},
        "kTcVerdict": {"n": 1, "max_ms": 530},
        "kMessage 9": {"n": 1, "max_ms": 520}}
    # The SLOW lines stay out of the other WARN kinds.
    assert all("SLOW" not in k for k in node["warn"])
    assert node["timeouts"] == 1 and node["proposed_blocks"] == 1


@pytest.mark.parametrize("kind,msg_kind,label", [
    (0, 4, "kMessage kSyncRequest"), (2, 1, "kVerdict"),
    (3, 0, "kTcVerdict"), (7, 1, "7")])
def test_slow_event_label(smoke, kind, msg_kind, label):
    assert smoke.slow_event_label(kind, msg_kind) == label
