"""The VM's AIRs: buses, system chips and the RV32IM executor chips."""
