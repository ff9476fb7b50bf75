"""Testbed settings loaded from settings.json
(benchmark/benchmark/settings.py:8-66 capability). Ports follow the
reference convention: consensus 8000, mempool 7000, front 6000.
"""

from __future__ import annotations

import json
from os.path import exists


class SettingsError(Exception):
    pass


class Settings:
    def __init__(self, testbed, key_name, key_path, base_port, repo_name,
                 repo_url, branch, instance_type, aws_regions, hosts=None):
        regions = (aws_regions if isinstance(aws_regions, list)
                   else [aws_regions])
        inputs_str = [testbed, key_name, key_path, repo_name, repo_url,
                      branch, instance_type] + regions
        if not all(isinstance(x, str) for x in inputs_str):
            raise SettingsError("Invalid settings types")
        if not isinstance(base_port, int):
            raise SettingsError("Invalid settings types")

        self.testbed = testbed
        self.key_name = key_name
        self.key_path = key_path
        self.base_port = base_port
        self.repo_name = repo_name
        self.repo_url = repo_url
        self.branch = branch
        self.instance_type = instance_type
        self.aws_regions = regions
        self.hosts = list(hosts or [])

    @classmethod
    def load(cls, filename="settings.json"):
        if not exists(filename):
            raise SettingsError(f"settings file {filename} not found")
        try:
            with open(filename, "r") as f:
                data = json.load(f)
            return cls(
                data["testbed"],
                data["key"]["name"],
                data["key"]["path"],
                data["ports"]["consensus"],
                data["repo"]["name"],
                data["repo"]["url"],
                data["repo"]["branch"],
                data["instances"]["type"],
                data["instances"]["regions"],
                hosts=data.get("hosts", []),
            )
        except (json.JSONDecodeError, KeyError) as e:
            raise SettingsError(f"Malformed settings: {e}")
