"""RSC15 (yoochoose-clicks): the preprocessing protocol and the asserting
harness of the three CIKM'18 configurations."""
