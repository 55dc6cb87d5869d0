"""Bucket replication: remote targets, async workers, resync."""
