"""Server-side encryption (SSE-S3 / SSE-C / SSE-KMS) and KMS."""
