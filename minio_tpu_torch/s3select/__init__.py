"""S3 Select: SQL over CSV/JSON objects with event-stream responses."""
