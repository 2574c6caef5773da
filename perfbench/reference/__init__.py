"""Plain references of the benchmark's configurations: torch operations in
float32, importing nothing of the port."""
