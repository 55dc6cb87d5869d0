"""The S3 front's own time per PUT (ms): the mean over the window's
PutObject requests answered 200 of their ``s3.request`` span less the
part its ``erasure.put_object`` child covers (SigV4, admission, the body,
the response). From the program's span ring (s3bench/spans.py)."""

from s3bench import spans


def read(w):
    return spans.front_ms(w)
