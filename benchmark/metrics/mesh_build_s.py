"""Seconds to build the mesh on the card (the program's `box_mesh`)."""


def read(rec):
    return rec["spans"].get("mesh_build")
