"""Rendering: the host camera and the forward megakernel."""
