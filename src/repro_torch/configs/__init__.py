"""Configurations of the paper's system (``igpm_paper``)."""
