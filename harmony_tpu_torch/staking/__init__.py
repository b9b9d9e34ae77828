"""Staking subsystem: EPoS effective-stake election math (reference:
staking/ — SURVEY.md §2.4).  The port's copy of the JAX package's
``staking/`` as far as it is ported: ``effective.py``."""
