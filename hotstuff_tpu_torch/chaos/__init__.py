"""graftchaos: scripted fault injection for the local testbed (the
port's copy of hotstuff_tpu/chaos).

The paper's claim — device-accelerated QC verification inside a live
HotStuff deployment — only matters if consensus stays live when the
accelerator path misbehaves.  The reference benchmarks model crash
faults as replicas that were never booted (benchmark/local.py:75-76);
Twins-style BFT testing (Bano et al.) shows that *scripted, mid-run*
fault schedules are what actually shake out recovery bugs.  This
package is the declarative half of that testing story:

  plan.py      fault-plan model + parser (JSON file, dict list, or a
               one-line DSL: ``"5 sidecar kill; 10 sidecar restart"``)
  runner.py    executes a plan against a running bench on its own
               thread, recording wall-clock timestamps per event
  recovery.py  per-fault recovery latency from the executed events and
               the committee's commit timeline (shared by the harness
               LogParser and bench.py's ``chaos`` headline field)
  netem.py     graftwan link shaping: per-host-pair WAN specs compiled
               to ``tc netem`` for fleets, with a root-free userspace
               TCP proxy (``WanProxy``) so local/CI runs exercise the
               identical plan schema
  slo.py       per-fault-class recovery SLOs: pass/fail verdicts over
               the recovery summary (shared by LogParser notes, the
               strict testbed assertion, and the bench headline)

The harness side (process murder, SIGSTOP partitions, sidecar chaos
RPCs, remote ssh injection) lives in ``harness/faults.py``, which the
port does not have yet (ROADMAP.md Queue A);
the sidecar's in-process fault hook (``OP_CHAOS``) in
``sidecar/service.py``.
"""

from .netem import LinkShape, WanError, WanProxy, WanSpec, \
    parse_wan  # noqa: F401
from .plan import ACTIONS, LEADER_CASCADE, FaultEvent, FaultPlan, \
    PlanError, cascade_k, client_index, link_name, node_index, \
    parse_plan  # noqa: F401
from .recovery import summarize_recovery  # noqa: F401
from .runner import PlanRunner  # noqa: F401
from .slo import DEFAULT_SLO_MS, SloError, fault_class, judge, \
    judge_baseline_recovery, parse_slos, throughput_series  # noqa: F401
