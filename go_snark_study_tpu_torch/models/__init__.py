"""Groth16 proof system of the port."""
