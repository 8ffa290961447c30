"""Host-side graph construction: vocabulary, PMI word graph, label co-occurrence."""
