"""Elastic fault detection and recovery
(↔ paddle_tpu/distributed/fleet/elastic/__init__.py)."""

from .manager import ElasticManager, ElasticStatus

__all__ = ["ElasticManager", "ElasticStatus"]
