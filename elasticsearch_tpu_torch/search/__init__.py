"""Query DSL and the serving path."""
