"""Cross-process coordination for the port (the part of
oni_ml_tpu/parallel ported so far): the replicated serving fleet's
file-KV membership (parallel/membership.py).  The multi-GPU EM modules
(mesh, collectives, sharded E-steps) wait for ROADMAP Queue 1 item 6."""
