"""Schwarz (SAP) smoothers."""
