"""Parallelism.  Only the pipeline stage planner is ported (used by
``tool_main info --pipeline-stages``); the parallel models are ROADMAP A14."""
