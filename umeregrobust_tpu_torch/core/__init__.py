"""SO(3) solvers, rigid transforms and UME core math."""
