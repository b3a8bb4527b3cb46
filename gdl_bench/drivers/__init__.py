"""General generators, one a traffic kind (``traffic/<name>.json`` names it)."""
