"""The runtime half of the JAX package's ``repro.analysis``: the sanitizer
lane (``sanitize``). The lint half (the AST rules over JAX/Pallas source)
is not ported: its rules are about JAX and Pallas (ROADMAP.md)."""
