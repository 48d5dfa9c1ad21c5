"""Score-matching losses."""
