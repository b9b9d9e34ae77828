"""Chain layer: block headers and the consensus-engine verification
surface (reference: block/ + internal/chain/engine.go — SURVEY.md §2.4,
call stack §3.3)."""
