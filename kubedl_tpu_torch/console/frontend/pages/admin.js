// Console user administration (reference pages/Admin + user management):
// list/add/update/delete console users; admin-only (server enforces 403).
import { api, esc, route, t } from "../app.js";

export async function viewAdmin(app) {
  const users = await api("/users");
  app.innerHTML = `
    <div class="panel">
      <div class="row"><h2 style="margin:0">${esc(t("admin.title"))}</h2></div>
      <table><thead><tr>
        <th>${esc(t("admin.username"))}</th>
        <th>${esc(t("admin.role"))}</th><th></th>
      </tr></thead><tbody>
        ${users.map(u => `<tr>
          <td>${esc(u.username)}</td>
          <td class="muted">${u.admin ? "admin" : "user"}</td>
          <td class="actions">
            <button class="danger" data-del="${esc(u.username)}">
              ${esc(t("jobs.delete"))}</button></td>
        </tr>`).join("")}
      </tbody></table>
      <h3>${esc(t("admin.add"))}</h3>
      <div class="form-grid">
        <label>${esc(t("admin.username"))}</label>
        <input data-field="username">
        <label>${esc(t("admin.password"))}</label>
        <input data-field="password" type="password">
        <label>${esc(t("admin.role"))}</label>
        <select data-field="admin">
          <option value="">user</option>
          <option value="1">admin</option>
        </select>
      </div>
      <div class="row">
        <button class="primary" id="u-save">${esc(t("sources.save"))}</button>
        <span id="u-msg" class="error"></span>
      </div>
    </div>`;

  const msg = app.querySelector("#u-msg");
  app.querySelector("#u-save").onclick = async () => {
    const get = k => app.querySelector(`[data-field="${k}"]`).value;
    try {
      await api("/users", {
        method: "POST",
        body: JSON.stringify({
          username: get("username"), password: get("password"),
          admin: !!get("admin"),
        }),
      });
      route();
    } catch (e) { msg.textContent = e.message; }
  };
  app.querySelectorAll("[data-del]").forEach(btn => btn.onclick = async () => {
    try {
      await api(`/users/${encodeURIComponent(btn.dataset.del)}`,
                { method: "DELETE" });
      route();
    } catch (e) { msg.textContent = e.message; }
  });
}
