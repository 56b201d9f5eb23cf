"""i-PI socket driver: serve forces to an i-PI (or compatible) MD server.

Port of ``xequinet_tpu/interface/ipi_driver.py``: a TCP or Unix socket
client speaking the i-PI wire protocol, answering POSDATA requests with
the energy, forces and virial of the port's Calculator (one
``Calculator.calculate`` per request, on the card unless
``device="cpu"``).

Protocol (i-Pi v1): little-endian; 12-byte space-padded ASCII headers
STATUS/READY/HAVEDATA/POSDATA/GETFORCE/FORCEREADY/INIT/EXIT; positions
and cell in Bohr, energy in Hartree, forces Ha/Bohr, virial Ha.
"""

from __future__ import annotations

import socket
import struct
from typing import Optional

import numpy as np

from .. import keys
from ..utils.logger import ZeroLogger
from ..utils.qc import unit_conversion
from .calculator import Calculator

HDRLEN = 12


def _send_header(sock: socket.socket, msg: str) -> None:
    sock.sendall(msg.ljust(HDRLEN).encode())


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("i-Pi server closed the connection")
        buf += chunk
    return buf


def _recv_header(sock: socket.socket) -> str:
    return _recv_exact(sock, HDRLEN).decode().strip()


class IPIDriver:
    """Client driver: connect to an i-Pi server and serve force calls."""

    def __init__(
        self,
        ckpt_file: str,
        atomic_numbers: np.ndarray,
        address: str = "localhost",
        port: int = 31415,
        unix: bool = False,
        charge: Optional[int] = None,
        spin: Optional[int] = None,
        logger=None,
        device=None,
    ) -> None:
        self.calc = Calculator(ckpt_file, compute_virial=True, device=device)
        self.z = np.asarray(atomic_numbers, dtype=np.int32)
        self.address = address
        self.port = port
        self.unix = unix
        self.charge = charge
        self.spin = spin
        self.logger = logger or ZeroLogger()
        u = self.calc.units
        # model units -> atomic units for the wire
        self._e_conv = unit_conversion(u.get(keys.TOTAL_ENERGY, "eV"), "Hartree")
        self._l_conv = unit_conversion("Bohr", u.get(keys.POSITIONS, "Angstrom"))
        self._have_data = False
        self._result = None

    # ------------------------------------------------------------------
    def _compute(self, cell_bohr: np.ndarray, pos_bohr: np.ndarray):
        pos = pos_bohr * self._l_conv  # Bohr -> model length units
        cell = cell_bohr * self._l_conv
        periodic = bool(np.abs(cell).max() > 1e-8)
        res = self.calc.calculate(
            self.z,
            pos,
            cell=cell if periodic else None,
            pbc=np.ones(3, bool) if periodic else None,
            charge=self.charge,
            spin=self.spin,
        )
        energy_ha = res[keys.TOTAL_ENERGY] * self._e_conv
        # F in Ha/Bohr = F_model * (Ha / E_model) * (L_model / Bohr)
        forces_ha_bohr = res[keys.FORCES] * self._e_conv * self._l_conv
        virial_ha = res.get(keys.VIRIAL, np.zeros((3, 3))) * self._e_conv
        return energy_ha, forces_ha_bohr, virial_ha

    # ------------------------------------------------------------------
    def run(self, max_steps: Optional[int] = None) -> int:
        if self.unix:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.connect(f"/tmp/ipi_{self.address}")
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.connect((self.address, self.port))
        self.logger.info(f"i-Pi driver connected to {self.address}:{self.port}")
        steps = 0
        try:
            while True:
                header = _recv_header(sock)
                if header == "STATUS":
                    if self._have_data:
                        _send_header(sock, "HAVEDATA")
                    else:
                        _send_header(sock, "READY")
                elif header == "INIT":
                    _recv_exact(sock, 4)  # bead index
                    (nbytes,) = struct.unpack("<i", _recv_exact(sock, 4))
                    _recv_exact(sock, nbytes)  # init string, ignored
                elif header == "POSDATA":
                    cell = np.frombuffer(_recv_exact(sock, 72), dtype="<f8").reshape(3, 3)
                    _icell = np.frombuffer(_recv_exact(sock, 72), dtype="<f8")
                    (natoms,) = struct.unpack("<i", _recv_exact(sock, 4))
                    if natoms != len(self.z):
                        raise ValueError(f"i-PI sent {natoms} atoms, the driver was "
                                         f"configured for {len(self.z)}")
                    pos = np.frombuffer(
                        _recv_exact(sock, 24 * natoms), dtype="<f8"
                    ).reshape(natoms, 3)
                    self._result = self._compute(cell.copy(), pos.copy())
                    self._have_data = True
                elif header == "GETFORCE":
                    energy, forces, virial = self._result
                    _send_header(sock, "FORCEREADY")
                    sock.sendall(struct.pack("<d", float(energy)))
                    sock.sendall(struct.pack("<i", len(self.z)))
                    sock.sendall(np.ascontiguousarray(forces, dtype="<f8").tobytes())
                    sock.sendall(np.ascontiguousarray(virial, dtype="<f8").tobytes())
                    sock.sendall(struct.pack("<i", 0))  # no extra string
                    self._have_data = False
                    steps += 1
                    if max_steps is not None and steps >= max_steps:
                        return steps
                elif header == "EXIT":
                    self.logger.info("i-Pi server sent EXIT")
                    return steps
                else:
                    raise ValueError(f"unknown i-Pi header {header!r}")
        finally:
            sock.close()
