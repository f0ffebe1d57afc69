"""Problem domains ported so far: Gavel cluster scheduling."""
