"""Cloud instance lifecycle (create/start/stop/terminate/hosts), gated on
boto3 availability — the reference's InstanceManager
(benchmark/benchmark/instance.py:18-263 capability). In environments
without cloud credentials/SDKs the harness still fully works against an
explicit host list (see remote.Bench).

The port's copy of hotstuff_tpu/harness/instance.py, unchanged: boto3
is imported only when a manager is made, and a missing boto3 raises
BenchError.
"""

from __future__ import annotations

from collections import defaultdict

from .settings import Settings
from .utils import BenchError, Print


class InstanceManager:
    INSTANCE_NAME = "hotstuff-tpu-node"
    SECURITY_GROUP_NAME = "hotstuff-tpu"

    def __init__(self, settings):
        assert isinstance(settings, Settings)
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise BenchError(
                "Cloud instance management needs boto3 (not installed); "
                "pass an explicit host list to remote.Bench instead", e)
        import boto3

        self.settings = settings
        self.clients = {
            region: boto3.client("ec2", region_name=region)
            for region in settings.aws_regions
        }

    @classmethod
    def make(cls, settings_file="settings.json"):
        return cls(Settings.load(settings_file))

    def _filters(self):
        return [{"Name": "tag:Name", "Values": [self.INSTANCE_NAME]}]

    def _instances(self, state):
        ids, ips = defaultdict(list), defaultdict(list)
        for region, client in self.clients.items():
            r = client.describe_instances(Filters=self._filters())
            for reservation in r["Reservations"]:
                for inst in reservation["Instances"]:
                    if inst["State"]["Name"] in state:
                        ids[region].append(inst["InstanceId"])
                        if "PublicIpAddress" in inst:
                            ips[region].append(inst["PublicIpAddress"])
        return ids, ips

    def create_instances(self, instances_per_region):
        for region, client in self.clients.items():
            # Open the three benchmark ports + ssh.
            try:
                sg = client.create_security_group(
                    GroupName=self.SECURITY_GROUP_NAME,
                    Description="hotstuff-tpu benchmark")
                base = self.settings.base_port
                perms = [
                    {"IpProtocol": "tcp",
                     "FromPort": p, "ToPort": p,
                     "IpRanges": [{"CidrIp": "0.0.0.0/0"}]}
                    for p in (22, base, base - 1000, base - 2000)
                ]
                client.authorize_security_group_ingress(
                    GroupId=sg["GroupId"], IpPermissions=perms)
            except client.exceptions.ClientError:
                pass  # group exists
            client.run_instances(
                ImageId=self._ubuntu_ami(client),
                InstanceType=self.settings.instance_type,
                KeyName=self.settings.key_name,
                MinCount=instances_per_region,
                MaxCount=instances_per_region,
                SecurityGroups=[self.SECURITY_GROUP_NAME],
                TagSpecifications=[{
                    "ResourceType": "instance",
                    "Tags": [{"Key": "Name",
                              "Value": self.INSTANCE_NAME}],
                }])
        Print.info(f"Created {instances_per_region} instances per region")

    @staticmethod
    def _ubuntu_ami(client):
        images = client.describe_images(
            Owners=["099720109477"],  # Canonical
            Filters=[{
                "Name": "name",
                "Values": ["ubuntu/images/hvm-ssd/ubuntu-jammy-22.04-"
                           "amd64-server-*"],
            }])["Images"]
        return sorted(images, key=lambda x: x["CreationDate"])[-1]["ImageId"]

    def start_instances(self):
        ids, _ = self._instances(["stopped", "stopping"])
        for region, client in self.clients.items():
            if ids[region]:
                client.start_instances(InstanceIds=ids[region])
        Print.info("Starting instances...")

    def stop_instances(self):
        ids, _ = self._instances(["pending", "running"])
        for region, client in self.clients.items():
            if ids[region]:
                client.stop_instances(InstanceIds=ids[region])
        Print.info("Stopping instances...")

    def terminate_instances(self):
        ids, _ = self._instances(
            ["pending", "running", "stopping", "stopped"])
        for region, client in self.clients.items():
            if ids[region]:
                client.terminate_instances(InstanceIds=ids[region])
        Print.info("Terminating instances...")

    def hosts(self, flat=True):
        _, ips = self._instances(["pending", "running"])
        return [x for y in ips.values() for x in y] if flat else dict(ips)

    def print_info(self):
        hosts = self.hosts(flat=False)
        text = ""
        for region, ips in hosts.items():
            text += f"\n Region: {region.upper()}\n"
            for i, ip in enumerate(ips):
                text += f"{i:>6}: ssh -i {self.settings.key_path} "
                text += f"ubuntu@{ip}\n"
        Print.info(text or " No instances")
