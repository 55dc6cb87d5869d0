"""S3-compatible HTTP API surface (L5/L6): auth, routing, handlers."""
