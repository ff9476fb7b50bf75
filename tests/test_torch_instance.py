"""The port's InstanceManager (hotstuff_tpu_torch/harness/instance.py)
through a stub boto3 EC2 model: the reference's tests
(tests/test_instance.py) on the port's module, and the same stub calls
and hosts as the reference's manager.  boto3 is not installed; the stub
implements just enough of the EC2 client surface (describe/run/start/
stop/terminate/describe_images, security-group calls) to drive every
InstanceManager method: filter logic, state partitioning, per-region
fan-out, newest-AMI selection, and the host listing the remote harness
consumes.
"""

import sys
import types

import pytest

from hotstuff_tpu_torch.harness.settings import Settings
from hotstuff_tpu_torch.harness.utils import BenchError


def make_settings(regions):
    return Settings("testbed", "key", "/tmp/key.pem", 9000, "repo",
                    "file:///repo", "main", "m5.xlarge", regions)


class StubEC2:
    """Minimal in-memory EC2 regional endpoint."""

    class exceptions:
        class ClientError(Exception):
            pass

    def __init__(self, region):
        self.region = region
        self.instances = []  # dicts: InstanceId, State, PublicIpAddress, Tags
        self.security_groups = {}
        self.calls = []

    # -- queries ---------------------------------------------------------

    def describe_instances(self, Filters):
        assert Filters == [{"Name": "tag:Name",
                            "Values": ["hotstuff-tpu-node"]}]
        insts = [i for i in self.instances
                 if {"Key": "Name", "Value": "hotstuff-tpu-node"}
                 in i["Tags"]]
        return {"Reservations": [{"Instances": insts}]}

    def describe_images(self, Owners, Filters):
        assert Owners == ["099720109477"]
        return {"Images": [
            {"ImageId": "ami-old", "CreationDate": "2023-01-01"},
            {"ImageId": "ami-new", "CreationDate": "2024-06-01"},
            {"ImageId": "ami-mid", "CreationDate": "2023-12-01"},
        ]}

    # -- mutations -------------------------------------------------------

    def create_security_group(self, GroupName, Description):
        if GroupName in self.security_groups:
            raise self.exceptions.ClientError("exists")
        self.security_groups[GroupName] = []
        return {"GroupId": f"sg-{GroupName}"}

    def authorize_security_group_ingress(self, GroupId, IpPermissions):
        self.security_groups[GroupId.removeprefix("sg-")] = IpPermissions

    def run_instances(self, **kw):
        self.calls.append(("run", kw))
        for i in range(kw["MinCount"]):
            n = len(self.instances)
            self.instances.append({
                "InstanceId": f"i-{self.region}-{n}",
                "State": {"Name": "pending"},
                "PublicIpAddress": f"198.51.100.{n + 1}",
                "Tags": kw["TagSpecifications"][0]["Tags"],
            })

    def _set_state(self, ids, state):
        for i in self.instances:
            if i["InstanceId"] in ids:
                i["State"] = {"Name": state}

    def start_instances(self, InstanceIds):
        self.calls.append(("start", InstanceIds))
        self._set_state(InstanceIds, "running")

    def stop_instances(self, InstanceIds):
        self.calls.append(("stop", InstanceIds))
        self._set_state(InstanceIds, "stopped")

    def terminate_instances(self, InstanceIds):
        self.calls.append(("terminate", InstanceIds))
        self._set_state(InstanceIds, "terminated")


@pytest.fixture
def stub_boto3(monkeypatch):
    endpoints = {}

    def client(service, region_name):
        assert service == "ec2"
        return endpoints.setdefault(region_name, StubEC2(region_name))

    mod = types.ModuleType("boto3")
    mod.client = client
    monkeypatch.setitem(sys.modules, "boto3", mod)
    return endpoints


def test_lifecycle_across_regions(stub_boto3):
    from hotstuff_tpu_torch.harness.instance import InstanceManager

    mgr = InstanceManager(make_settings(["eu-north-1", "us-west-1"]))
    mgr.create_instances(2)
    eu = stub_boto3["eu-north-1"]
    us = stub_boto3["us-west-1"]
    assert len(eu.instances) == 2 and len(us.instances) == 2
    # newest AMI picked, security group ports opened (22 + the 3 bench
    # ports derived from base_port)
    assert eu.calls[0][1]["ImageId"] == "ami-new"
    ports = sorted(p["FromPort"]
                   for p in eu.security_groups["hotstuff-tpu"])
    assert ports == [22, 7000, 8000, 9000]

    # pending instances are visible hosts
    assert len(mgr.hosts()) == 4
    assert mgr.hosts(flat=False)["eu-north-1"] == ["198.51.100.1",
                                                   "198.51.100.2"]

    # stop targets pending/running; start brings stopped back
    mgr.stop_instances()
    assert all(i["State"]["Name"] == "stopped" for i in eu.instances)
    assert mgr.hosts() == []
    mgr.start_instances()
    assert all(i["State"]["Name"] == "running" for i in us.instances)
    assert len(mgr.hosts()) == 4

    mgr.terminate_instances()
    assert all(i["State"]["Name"] == "terminated" for i in eu.instances)
    assert mgr.hosts() == []

    # idempotent security group creation on a second create pass
    mgr.create_instances(1)
    assert len(eu.instances) == 3


def test_untagged_instances_invisible(stub_boto3):
    from hotstuff_tpu_torch.harness.instance import InstanceManager

    mgr = InstanceManager(make_settings(["eu-north-1"]))
    ec2 = stub_boto3["eu-north-1"]
    ec2.instances.append({
        "InstanceId": "i-other", "State": {"Name": "running"},
        "PublicIpAddress": "203.0.113.9",
        "Tags": [{"Key": "Name", "Value": "unrelated"}],
    })
    assert mgr.hosts() == []


def test_missing_boto3_is_a_bench_error(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_boto3(name, *a, **kw):
        if name == "boto3":
            raise ImportError("No module named 'boto3'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_boto3)
    monkeypatch.delitem(sys.modules, "boto3", raising=False)
    from hotstuff_tpu_torch.harness.instance import InstanceManager

    with pytest.raises(BenchError):
        InstanceManager(make_settings(["eu-north-1"]))


def test_lifecycle_equals_the_reference(stub_boto3):
    """The same lifecycle through both managers makes the same EC2 calls
    and lists the same hosts at each step."""
    from hotstuff_tpu.harness.instance import InstanceManager as Ref
    from hotstuff_tpu.harness.settings import Settings as RefSettings
    from hotstuff_tpu_torch.harness.instance import InstanceManager

    out = []
    for manager, settings in ((Ref, RefSettings), (InstanceManager,
                                                   Settings)):
        stub_boto3.clear()
        mgr = manager(settings("testbed", "key", "/tmp/key.pem", 9000,
                               "repo", "file:///repo", "main", "m5.xlarge",
                               ["eu-north-1", "us-west-1"]))
        steps = []
        for step in (lambda: mgr.create_instances(2), mgr.stop_instances,
                     mgr.start_instances, mgr.terminate_instances):
            step()
            steps.append(mgr.hosts(flat=False))
        out.append((steps, {r: e.calls for r, e in stub_boto3.items()}))
    assert out[1] == out[0]
