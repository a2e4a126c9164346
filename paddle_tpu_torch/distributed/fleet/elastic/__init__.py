"""Elastic recovery (counterpart of ``paddle_tpu/distributed/fleet/
elastic/``): only ``resume.opt_state_tensors`` / ``_apply_opt_state``,
which ``ParallelEngine``'s checkpoints use, are ported; the manager, the
relaunch loop and resharding across world sizes wait on ROADMAP.md
queue 1, item 11."""
