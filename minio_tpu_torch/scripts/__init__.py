"""The port's counterparts of the repository's ``scripts/``: the diag
plane's smoke (``python -m minio_tpu_torch.scripts.diag_smoke``) and the
regeneration of the vendored reference surface
(``python -m minio_tpu_torch.scripts.gen_reference_surface``)."""
