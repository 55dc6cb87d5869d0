"""Batch jobs: YAML-driven replicate/expire with checkpointed progress."""
