"""Utilities of the LLM scaffold: ``roofline`` (the dry run's analytic
roofline terms)."""
