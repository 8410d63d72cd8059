"""Server-side aggregation algorithms."""
