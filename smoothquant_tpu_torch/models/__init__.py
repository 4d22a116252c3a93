"""Model forwards (Llama) and packing dispatch."""
