"""Committee data model and election (reference: shard/ +
shard/committee/assignment.go — SURVEY.md §2.2)."""
