"""Replication: mesh membership, per-peer links, sync state machines."""

from .manager import ReplicaManager, ReplicaMeta

__all__ = ["ReplicaManager", "ReplicaMeta"]
