"""The plan cache's tools: the probes that measure the tuned knobs and
record the winners (em_chunk_probe, estep_probe, score_probe,
pre_probe), and the cache's show/clear/export command (plan_cache).
Each runs as `python -m oni_ml_tpu_torch.tools.<name>`, prints one JSON
line per measurement, and (the probes) ends with a `plan_cache_update`
line.  Nothing here runs at import time."""
