"""Bucket event notifications: config, targets, dispatch, listen API."""
