"""Plain references of the benchmark's deployments (NumPy only): each
module makes a deployment's tables from a seed and answers its queries. A
configuration names its module under ``"reference"``."""
