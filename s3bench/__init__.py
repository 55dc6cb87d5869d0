"""The benchmark of minio_tpu_torch: signed S3 traffic into the port's
server on one card. ``python3 s3bench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
