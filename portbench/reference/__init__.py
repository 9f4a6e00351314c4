"""The benchmark's plain reference: what the port's answers are judged by.

It imports torch and numpy only: nothing of the program under test and
nothing of the JAX package (the harness checks the modules it pulls in).
"""
